"""The wall-paced driver on the CPU at smoke size: the engine's clock
never falls across a step and ends at the wall, a tool whose drawn
duration is d returns no earlier than d wall seconds after its
call_start, and every registered app is finished, unfinished or not yet
arrived at the end."""

import pytest

from tokenbench import driver, harness, model, traffic


def build(tb, cell="dense.mini", seed=11):
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.costmodel import A100_PCIE
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.launch.http_server import graph_from_spec

    bench = harness.Bench(tb.parent, tb)
    c = bench.cell(cell)
    spec = bench.config(c["config"])
    dep = bench.deployment(cell)
    s = model.shapes(spec)
    ecfg = EngineConfig.preset("tokencake", gpu_blocks=dep["gpu_blocks"],
                               host_blocks=dep["host_blocks"], seed=seed,
                               **dep.get("engine", {}))
    be = TorchBackend(model.model_config(spec), ecfg, A100_PCIE,
                      device="cpu", params=model.make_params(s, seed, "cpu"))
    eng = Engine(ecfg, A100_PCIE, backend=be)
    mix = bench.traffic(c["traffic"])
    mix["vocab"] = s["vocab"]
    for a in traffic.schedule(mix, seed):
        eng.submit_app(graph_from_spec(a["spec"]), a["arrival"], a["prompts"])
    return eng, be


def test_clock_follows_the_wall_and_tools_take_wall_seconds(smoke):
    root, tb = smoke
    eng, be = build(tb)
    rec = driver.Recorder(eng, be)
    starts, finishes = [], {}
    step, call_finish = eng.step, eng.call_finish

    def step_hook():
        starts.append((eng.clock, rec.now()))
        return step()

    def call_finish_hook(req):
        finishes.setdefault((req.rid, req.segment), rec.now())
        call_finish(req)

    eng.step, eng.call_finish = step_hook, call_finish_hook
    driver.drive(eng, rec, 8.0)
    clocks = [c for c, _ in starts] + [eng.clock]
    assert len(starts) > 10
    assert all(b >= a for a, b in zip(clocks, clocks[1:]))
    # the clock is never ahead of the wall by more than a pending event
    # it sleeps towards, and ends within a step of it
    assert eng.clock == pytest.approx(rec.now(), abs=0.5)
    assert len(rec.calls) >= 5
    checked = 0
    for rid, seg, wall, clock, due in rec.calls:
        d = due - clock
        assert clock >= wall and d > 0
        if (rid, seg) in finishes:
            assert finishes[(rid, seg)] >= wall + d
            checked += 1
    assert checked >= 2
    acc = harness.accounting(eng, rec.now())
    assert acc["finished"] >= 1
    assert acc["finished"] + acc["unfinished"] + acc["not_arrived"] == \
        acc["registered"] == 8


def test_tokens_are_stamped_after_the_argmax(smoke):
    root, tb = smoke
    eng, be = build(tb)
    rec = driver.Recorder(eng, be)
    driver.drive(eng, rec, 3.0)
    assert rec.tokens and rec.decodes
    ends = {t1 for _, t1, _ in rec.decodes}
    assert all(t in ends for t, *_ in rec.tokens)
    # only served tokens: never more per segment than its target
    per = {}
    for _, rid, seg, idx in rec.tokens:
        per.setdefault((rid, seg), set()).add(idx)
    for (rid, seg), idxs in per.items():
        req = eng._find(rid)
        assert max(idxs) < req.node.decode_segments[seg]
        assert len(idxs) == max(idxs) + 1
