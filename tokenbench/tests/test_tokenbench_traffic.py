"""The frozen copies under tokenbench/ against the serving package's
originals, as they stand when the copy was made: the app builders and the
length samplers (``data/workloads.py``, ``data/pipeline.py``) and the
roofline bound (``chip_smoke.bound_ms``)."""
import numpy as np
import pytest

from tokenbench import peaks, traffic
from tokenbench.tests.smoke import BENCH, ROOT


@pytest.mark.parametrize("app,dataset", [("code_writer", "d2"),
                                         ("deep_research", "d1")])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_apps_match_the_serving_package(app, dataset, seed):
    from repro_torch.data.workloads import build_workload
    from repro_torch.launch.http_server import graph_from_spec

    mix = traffic.load(BENCH / "traffic" / f"{app}.json")
    mix.update(schedule_seed=seed, n_apps=6, vocab=100)
    mine = traffic.schedule(mix, 0)
    ref = build_workload(app, dataset, qps=mix["arrivals"]["rate"],
                         n_apps=6, seed=seed)
    assert len(mine) == len(ref)
    for m, (t, g) in zip(mine, ref):
        assert m["arrival"] == pytest.approx(t, rel=0, abs=1e-9)
        g2 = graph_from_spec(m["spec"])
        for a, b in zip(g2.nodes.values(), g.nodes.values()):
            assert (a.name, a.prompt_len, a.decode_segments, a.deps) == \
                (b.name, b.prompt_len, b.decode_segments, b.deps)
            assert [(f.name, f.tool, f.predict_time, f.variability)
                    for f in a.func_calls if f] == \
                [(f.name, f.tool, f.predict_time, f.variability)
                 for f in b.func_calls if f]


@pytest.mark.parametrize("kind,mix", [("sharegpt", "deep_research"),
                                      ("agentcode", "code_writer")])
def test_samplers_match_the_serving_package(kind, mix):
    from repro_torch.data.pipeline import output_lengths, prompt_lengths

    lengths = traffic.load(BENCH / "traffic" / f"{mix}.json")["lengths"]
    for seed in (1, 2, 3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(200):
            assert traffic.lognormal_length(a, lengths["prompt"]) == \
                prompt_lengths(b, kind)
            assert traffic.lognormal_length(a, lengths["output"]) == \
                output_lengths(b, kind)


def test_the_seed_draws_the_tokens_and_nothing_else():
    mix = traffic.load(BENCH / "traffic" / "code_writer.json")
    mix.update(vocab=1000)
    a, b = traffic.schedule(mix, 1), traffic.schedule(mix, 2**31 + 9)
    assert [(x["arrival"], x["spec"]) for x in a] == \
        [(x["arrival"], x["spec"]) for x in b]
    assert a[0]["prompts"] != b[0]["prompts"]
    assert traffic.schedule(mix, 1)[0]["prompts"] == a[0]["prompts"]
    for x in a:
        for i, nd in enumerate(x["spec"]["nodes"]):
            assert len(x["prompts"][i]) == nd["prompt_len"]


def test_bound_matches_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for nbytes, flops, dt in ((1e9, 1e12, "bf16"), (1e6, 1e12, "bf16"),
                              (3e8, 2e9, "f32")):
        ms, which = cs.bound_ms(nbytes, flops, dt)
        s, which2 = peaks.bound_s(nbytes, flops, dt)
        assert (s * 1e3, which2) == (pytest.approx(ms, rel=1e-12), which)
