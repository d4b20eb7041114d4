"""The harness on the CPU at smoke size: the result line's keys, the
refusal without a card, the discovery of files added by name, the import
rules, the reference against the port, the control, and the faults that
must turn ``correct`` false."""
import json
import subprocess
import sys

import pytest
import torch

from tokenbench import run
from tokenbench.tests.smoke import BENCH, ROOT, run_smoke

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", ["dense.mini", "moe.mini"])
def test_smoke_run_meets_the_contract_and_the_reference(smoke, cell):
    root, tb = smoke
    out = run_smoke(root, tb, cell)
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"gen_tok_per_s", "ttft_p90_ms", "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert out["device"]["platform"] == "cpu"
    gap = out["checks"]["logit_gap_max"]
    assert gap["value"] <= gap["limit"] / 4
    assert out["checks"]["tokens_judged"]["value"] >= 10
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("cell", ["dense.mini", "moe.mini"])
def test_control_fails_the_limit(smoke, cell):
    import time

    from tokenbench import harness
    root, tb = smoke
    run = harness.serve(harness.Bench(root, tb), cell, 2**31 + 7, 4.0, False,
                        time.perf_counter(), device="cpu", log=lambda m: None)
    correct, checks = harness.judge(run, lambda m: None)
    ctl, ctl_checks = harness.judge(run, lambda m: None, control="fp8")
    assert correct is True and ctl is False
    gap, ctl_gap = checks["logit_gap_max"], ctl_checks["logit_gap_max"]
    assert ctl_gap["value"] > gap["limit"]
    assert gap["value"] * 3 < ctl_gap["value"]


def test_traced_run_needs_a_card(smoke):
    import time

    from tokenbench import harness
    root, tb = smoke
    with pytest.raises(RuntimeError, match="needs a card"):
        harness.run_cell(root, "dense.mini", 1, 2.0, True,
                         time.perf_counter(), device="cpu", bench_dir=tb)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "qwen14b.code_writer", "--seed", str(2**31 + 3), "--seconds", "10",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_files_added_by_name_are_found(smoke):
    root, tb = smoke
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((tb / "configs" / "dense-smoke.json").read_text())
    cfg["name"] = "dense-smoke-3l"
    cfg["config"]["num_hidden_layers"] = 3
    (tb / "configs" / "dense-smoke-3l.json").write_text(json.dumps(cfg))
    mix = json.loads((tb / "traffic" / "mini.json").read_text())
    mix["arrivals"]["rate"] = 2.0
    (tb / "traffic" / "mini2.json").write_text(json.dumps(mix))
    (tb / "cells" / "new.cell.json").write_text(
        (tb / "cells" / "dense.mini.json").read_text())
    (tb / "metrics" / "tokens_served.py").write_text(
        "def read(ctx):\n"
        "    w0, w1 = ctx.window\n"
        "    return sum(1 for t, *_ in ctx.rec.tokens if w0 <= t <= w1)\n")
    bench["configs"].append(dict(bench["configs"][0], name="dense-smoke-3l",
                                 file="tb/configs/dense-smoke-3l.json"))
    bench["workloads"].append({"name": "new.cell", "config": "dense-smoke-3l",
                               "traffic": "mini2", "chips": 1, "why": "new"})
    bench["end_to_end"].append({"name": "tokens_served", "unit": "tokens",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["new.cell"]})
    # a reader with nothing to read leaves its metric out of the line
    (tb / "metrics" / "nothing_read.py").write_text(
        "def read(ctx):\n    return None\n")
    bench["end_to_end"].append(dict(bench["end_to_end"][-1],
                                    name="nothing_read"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_smoke(root, tb, "new.cell", seconds=3.0)
    assert out["metrics"]["tokens_served"]["value"] > 0
    assert "nothing_read" not in out["metrics"]
    assert out["correct"] is True


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_loaded(["repro_torch", "repro_torch.core", "reprox",
                                 "jaxtyping", "torch"]) == []
    assert run.forbidden_loaded(["repro.core.engine", "jax.numpy",
                                 "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def _loaded_after(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
         + code + "\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    from tokenbench.tests.smoke import write_bench
    tb = write_bench(tmp_path)
    loaded = _loaded_after(
        "import time, pathlib\n"
        "from tokenbench import run, harness, calibrate\n"
        f"harness.run_cell(pathlib.Path({str(tmp_path)!r}), 'dense.mini', 3,"
        f" 1.0, False, time.perf_counter(), device='cpu',"
        f" bench_dir=pathlib.Path({str(tb)!r}), log=lambda m: None)")
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_port():
    loaded = _loaded_after(
        "from tokenbench.reference import check, decoder\n"
        "from tokenbench import peaks")
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


# -- faults of the timed path, each must turn ``correct`` false ---------------

def _token_altered(monkeypatch):
    from repro_torch.core.backend import TorchBackend
    orig = TorchBackend._decode_batch

    def altered(self, reqs):
        orig(self, reqs)
        for r in reqs:
            g = self.generated[r.rid]
            g[-1] = (g[-1] + 1) % self.cfg.vocab_size
    monkeypatch.setattr(TorchBackend, "_decode_batch", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.models.graphs import EagerSteps
    orig = EagerSteps.decode

    def unchanged(self, params, k, v, *inputs):
        return orig(self, params, k.clone(), v.clone(), *inputs)
    monkeypatch.setattr(EagerSteps, "decode", unchanged)


def _half_batch(monkeypatch):
    from repro_torch.models.graphs import EagerSteps
    orig = EagerSteps.decode

    def half(self, params, k, v, tokens, tables, positions, attn_lens,
             slots):
        n = max(int((attn_lens > 0).sum()) // 2, 1)
        lens, sl = attn_lens.copy(), slots.copy()
        lens[n:] = 0
        sl[n:] = k.shape[1] * k.shape[2] - k.shape[2]   # the scratch slot
        return orig(self, params, k, v, tokens, tables, positions, lens, sl)
    monkeypatch.setattr(EagerSteps, "decode", half)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
def test_a_broken_timed_path_is_not_correct(smoke, monkeypatch, fault):
    root, tb = smoke
    fault(monkeypatch)
    out = run_smoke(root, tb, "dense.mini")
    assert out["correct"] is False
    assert out["checks"]["logit_gap_max"]["value"] > \
        out["checks"]["logit_gap_max"]["limit"]
