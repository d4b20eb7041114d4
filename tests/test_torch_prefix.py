"""The shared-prefix data plane of ``tests/test_prefix_prefill.py`` on the
port: suffix-only paged prefill and copy-on-write forks through
``TorchBackend`` (on the CPU) under the engine.

Each scenario runs twice on the same weights, through ``repro.core.Engine``
with ``JaxBackend`` and through ``repro_torch.core.Engine`` with
``TorchBackend`` (``torch_engine_pair``):
* ``test_port_matches_jax``: the same tokens per rid, every engine counter
  equal (prefix hits, saved tokens, COW forks, offloads, wire bytes,
  ``prefill_tokens``), prefill logits within 1e-5;
* the reference test of the same name, its assertions checked on the
  port's record, the dense reference being the port's own
  ``models.model.prefill``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_engine_pair import torch_one_thread  # noqa: F401 (autouse)
from torch_engine_pair import (TINY, assert_same, caught, record, run_both,
                               run_out, step, submit_one)

BT = 16
TOL = dict(atol=2e-4, rtol=2e-4)


def mk_engine(P, gpu_blocks=64, **kw):
    cfg = P.ModelConfig(**TINY)
    ecfg = P.EngineConfig.preset("vllm_prefix", gpu_blocks=gpu_blocks,
                                 host_blocks=32, max_running=8,
                                 sched_quantum=4, **kw)
    backend = P.backend(cfg, ecfg, P.A100_PCIE)
    return P.Engine(ecfg, P.A100_PCIE, backend=backend), backend


def by_name(eng):
    return {r.rid.split("/")[-1]: r for r in eng.running}


def concurrent_same_prefix(P):
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, 50000, 3 * BT)]
    sfx_a = [int(t) for t in rng.integers(0, 50000, 10)]
    sfx_b = [int(t) for t in rng.integers(0, 50000, 7)]
    eng, backend = mk_engine(P)
    submit_one(P, eng, prefix + sfx_a, decode_len=64, name="a")
    step(eng)
    used_single = eng.cfg.gpu_blocks - eng.pools[0].free
    submit_one(P, eng, prefix + sfx_b, decode_len=64, name="b")
    step(eng)
    ra, rb = by_name(eng)["a"], by_name(eng)["b"]
    return record(
        eng, backend, rids=(ra.rid, rb.rid),
        shared_b=rb.shared_prefix_blocks,
        same_blocks=rb.gpu_blocks[:3] == ra.gpu_blocks[:3],
        cached_b=rb.prefix_cached_tokens, used_single=used_single,
        used_both=eng.cfg.gpu_blocks - eng.pools[0].free,
        dense={ra.rid: P.dense_logits(backend, prefix + sfx_a),
               rb.rid: P.dense_logits(backend, prefix + sfx_b)})


def identical_prompts_cow(P):
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(0, 50000, 2 * BT + 5)]
    ref_eng, ref_backend = mk_engine(P)
    submit_one(P, ref_eng, prompt, decode_len=12)
    run_out(ref_eng, 30)
    (ref_toks,) = ref_backend.generated.values()
    eng, backend = mk_engine(P)
    submit_one(P, eng, prompt, decode_len=12)
    step(eng)
    submit_one(P, eng, prompt, decode_len=12)
    step(eng)
    forks = eng.metrics["cow_forks"]
    full_hit = any(r.prefix_cached_tokens == len(prompt)
                   for r in eng.running)
    run_out(eng, 30)
    return record(eng, backend, ref_toks=list(ref_toks), forks=forks,
                  full_hit=full_hit)


def preempted_reuses_prefix(P):
    rng = np.random.default_rng(2)
    prompt = [int(t) for t in rng.integers(0, 50000, 3 * BT)]
    eng, backend = mk_engine(P)
    submit_one(P, eng, prompt, decode_len=24)
    step(eng)
    (req,) = eng.running
    shared = list(req.gpu_blocks[:req.shared_prefix_blocks])
    for _ in range(2):
        step(eng)
    gen_before = list(backend.generated[req.rid])
    eng._evict(req, None)
    saved0 = eng.metrics["prefix_saved_tokens"]
    step(eng)
    readmitted = (req.state == P.ReqState.RUNNING,
                  req.gpu_blocks[:len(shared)] == shared,
                  req.prefix_cached_tokens)
    saved1 = eng.metrics["prefix_saved_tokens"]
    run_out(eng, 20)
    return record(eng, backend, rid=req.rid, shared=shared,
                  gen_before=gen_before, saved=(saved0, saved1),
                  readmitted=readmitted)


def copy_out_private_only(P):
    cfg = P.ModelConfig(**TINY)
    ecfg = P.EngineConfig.preset("baseline", gpu_blocks=24, host_blocks=8)
    backend = P.backend(cfg, ecfg, P.A100_PCIE)
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, 50000, 3 * BT)]
    g = P.AppGraph("t")
    node = g.add_agent("a", "w", len(prompt), decode_len=8)
    r = P.Request(rid="r", app_id="a", node=node, graph=g, arrival=0.0,
                  prompt_tokens=prompt)
    r.gpu_blocks_by_device[0] = [1, 2, 3]
    backend.decode([r])
    r.shared_prefix_blocks = 1
    snap = P.pool_k(backend, [2, 3])
    r.host_blocks = [0, 1]
    backend.copy_out(r)
    P.zero_blocks(backend, [2, 3])
    r.gpu_blocks_by_device[0] = [1]
    r.reserved_upload_blocks = [6, 7]
    backend.copy_in(r)
    return dict(snap=snap, restored=P.pool_k(backend, [6, 7]),
                tokens=dict(backend.generated),
                logits=dict(backend.last_prefill_logits))


def sharing_with_offload(P):
    cfg = P.ModelConfig(**TINY)
    ecfg = P.EngineConfig.preset("mooncake", gpu_blocks=32, host_blocks=128,
                                 max_running=4, prefix_cache=True)
    backend = P.backend(cfg, ecfg, P.A100_PCIE)
    eng = P.Engine(ecfg, P.A100_PCIE, backend=backend)
    for t, g in P.build_workload("deep_research", qps=8.0, n_apps=6,
                                 seed=0):
        for n in g.nodes.values():
            n.prompt_len = min(n.prompt_len, 48)
            n.decode_segments = [min(s, 8) for s in n.decode_segments]
        eng.submit_app(g, t)
    rep = eng.run(max_time=8000)
    p = eng.pools[0]
    return record(eng, backend, report=rep,
                  pool=(p.free + len(p.pending_free), p.num_blocks),
                  pins=len(eng.prefix_store.pins))


def mid_block_divergence(P):
    rng = np.random.default_rng(7)
    prefix = [int(t) for t in rng.integers(0, 50000, 3 * BT + 8)]
    n = 4
    suffixes = [[int(t) for t in rng.integers(0, 50000, 9 + i)]
                for i in range(n)]
    eng, backend = mk_engine(P, gpu_blocks=96)
    submit_one(P, eng, prefix + suffixes[0], decode_len=48, name="a0")
    step(eng)
    used_single = eng.cfg.gpu_blocks - eng.pools[0].free
    for i in range(1, n):
        submit_one(P, eng, prefix + suffixes[i], decode_len=48, name=f"a{i}")
    step(eng)
    reqs = by_name(eng)
    assert len(reqs) == n
    r0 = reqs["a0"]
    sharers = [dict(shared=reqs[f"a{i}"].shared_prefix_blocks,
                    same3=reqs[f"a{i}"].gpu_blocks[:3] == r0.gpu_blocks[:3],
                    cached=reqs[f"a{i}"].prefix_cached_tokens,
                    forked=reqs[f"a{i}"].gpu_blocks[3] != r0.gpu_blocks[3])
               for i in range(1, n)]
    used_all = eng.cfg.gpu_blocks - eng.pools[0].free
    eng.prefix_store.check_invariants()
    dense = {reqs[f"a{i}"].rid: P.dense_logits(backend,
                                               prefix + suffixes[i])
             for i in range(n)}
    admitted = record(eng, backend)
    run_out(eng, 60)
    eng.prefix_store.check_invariants()
    return record(eng, backend, admitted=admitted, sharers=sharers,
                  used_single=used_single, used_all=used_all, dense=dense,
                  pins=len(eng.prefix_store.pins))


def preempt_and_offload_pins(P):
    rng = np.random.default_rng(11)
    prefix = [int(t) for t in rng.integers(0, 50000, 2 * BT + 6)]
    sfx = [[int(t) for t in rng.integers(0, 50000, 8 + i)] for i in range(3)]
    eng, backend = mk_engine(P, gpu_blocks=64)
    submit_one(P, eng, prefix + sfx[0], decode_len=40, name="a")
    step(eng)
    submit_one(P, eng, prefix + sfx[1], decode_len=40, name="b")
    submit_one(P, eng, prefix + sfx[2], decode_len=40, name="c")
    step(eng)
    reqs = by_name(eng)
    ra, rb, rc = reqs["a"], reqs["b"], reqs["c"]
    anc = list(rb.gpu_blocks[:2])
    ancestors = (anc == rc.gpu_blocks[:2] == ra.gpu_blocks[:2])
    forks0 = eng.metrics["cow_forks"]
    step(eng)
    eng._evict(rb, None)
    saved0 = eng.metrics["prefix_saved_tokens"]
    eng.prefix_store.check_invariants()
    owners = [eng.pools[0].meta[b].owner == P.SHARED_OWNER for b in anc]
    rc.state = P.ReqState.STALLED
    eng.stalled[rc.rid] = rc
    eng.running.remove(rc)
    eng._start_offload(rc)
    offloaded = (len(rc.host_blocks), rc.offloadable_blocks)
    eng._process_events_until(eng.stream_free_at + 1e-6)
    kept = (rc.gpu_blocks[:2] == anc,
            len(rc.gpu_blocks) == rc.shared_prefix_blocks)
    step(eng)
    readmitted = (rb.state == P.ReqState.RUNNING, rb.gpu_blocks[:2] == anc,
                  rb.prefix_cached_tokens)
    saved1, forks1 = (eng.metrics["prefix_saved_tokens"],
                      eng.metrics["cow_forks"])
    eng.prefix_store.check_invariants()
    gen_before = list(backend.generated[rb.rid])
    for _ in range(40):
        step(eng)
        if rb.done:
            break
    eng.prefix_store.check_invariants()
    return record(eng, backend, rid=rb.rid, ancestors=ancestors,
                  forks=(forks0, forks1), saved=(saved0, saved1),
                  owners=owners, offloaded=offloaded, kept=kept,
                  readmitted=readmitted, gen_before=gen_before)


def prompt_exceeding_allocation(P):
    cfg = P.ModelConfig(**TINY)
    ecfg = P.EngineConfig.preset("baseline", gpu_blocks=16, host_blocks=8)
    backend = P.backend(cfg, ecfg, P.A100_PCIE)
    g = P.AppGraph("t")
    node = g.add_agent("a", "w", 3 * BT, decode_len=8)
    rng = np.random.default_rng(3)
    r = P.Request(rid="r", app_id="a", node=node, graph=g, arrival=0.0,
                  prompt_tokens=[int(t) for t in
                                 rng.integers(0, 50000, 3 * BT)])
    r.gpu_blocks_by_device[0] = [1, 2]
    msgs = caught(lambda: backend.decode([r]))
    return dict(warned=any("prefill truncation" in m for m in msgs),
                truncated=backend.truncated_prompt_tokens,
                tokens=dict(backend.generated),
                logits=dict(backend.last_prefill_logits))


SCENARIOS = {f.__name__: f for f in (
    concurrent_same_prefix, identical_prompts_cow, preempted_reuses_prefix,
    copy_out_private_only, sharing_with_offload, mid_block_divergence,
    preempt_and_offload_pins, prompt_exceeding_allocation)}


@pytest.fixture(scope="module")
def runs():
    done = {}

    def get(name):
        if name not in done:
            done[name] = run_both(SCENARIOS[name])
        return done[name]
    return get


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_matches_jax(runs, name):
    want, got = runs(name)
    assert_same(want, got)


def test_concurrent_same_prefix_requests_share_blocks_same_logits(runs):
    o = runs("concurrent_same_prefix")[1]
    ra, rb = o["rids"]
    assert o["shared_b"] >= 3 and o["same_blocks"]
    assert o["cached_b"] == 3 * BT
    assert o["used_both"] < 2 * o["used_single"]
    for rid in (ra, rb):
        np.testing.assert_allclose(o["logits"][rid], o["dense"][rid], **TOL)
    assert o["metrics"]["prefix_saved_tokens"] >= 3 * BT


def test_identical_prompts_cow_fork_and_decode_matches_reference(runs):
    o = runs("identical_prompts_cow")[1]
    assert len(o["ref_toks"]) >= 12
    assert o["forks"] == 1 and o["full_hit"]
    assert len(o["tokens"]) == 2
    for rid, toks in o["tokens"].items():
        assert toks[:12] == o["ref_toks"][:12], rid


def test_preempted_request_reuses_surviving_prefix_blocks(runs):
    o = runs("preempted_reuses_prefix")[1]
    assert o["shared"] and o["gen_before"]
    running, same_blocks, cached = o["readmitted"]
    assert running and same_blocks
    assert cached >= 3 * BT - BT
    assert o["saved"][1] > o["saved"][0]
    got = o["tokens"][o["rid"]]
    assert got[:len(o["gen_before"])] == o["gen_before"]


def test_copy_out_moves_only_private_blocks_with_shared_prefix(runs):
    o = runs("copy_out_private_only")[1]
    np.testing.assert_array_equal(o["restored"], o["snap"])


def test_prefix_sharing_composes_with_offload_end_to_end(runs):
    o = runs("sharing_with_offload")[1]
    rep = o["report"]
    assert rep["apps_finished"] == 6
    assert rep["offloads"] >= 1
    assert rep["prefix_hits"] > 0
    assert o["pool"][0] == o["pool"][1]
    assert o["pins"] == 0


def test_multi_agent_mid_block_divergence_shares_sublinearly(runs):
    o = runs("mid_block_divergence")[1]
    n = len(o["sharers"]) + 1
    for s in o["sharers"]:
        assert s["shared"] >= 3 and s["same3"] and s["forked"]
        assert s["cached"] == 3 * BT + 8
    m = o["admitted"]["metrics"]
    assert m["cow_forks"] == n - 1
    assert m["prefix_saved_tokens"] >= (n - 1) * (3 * BT + 8)
    assert o["used_all"] < n * o["used_single"]
    assert o["used_all"] <= o["used_single"] + (n - 1) * (
        o["used_single"] - 3)
    for rid, want in o["dense"].items():
        np.testing.assert_allclose(o["admitted"]["logits"][rid], want, **TOL)
    assert o["pins"] == 0


def test_preemption_and_offload_keep_radix_pins_coherent(runs):
    o = runs("preempt_and_offload_pins")[1]
    assert o["ancestors"]
    forks0, forks1 = o["forks"]
    assert forks0 == 2 and forks1 == forks0 + 1
    assert all(o["owners"])
    assert o["offloaded"][0] == o["offloaded"][1]
    assert all(o["kept"])
    running, same_anc, cached = o["readmitted"]
    assert running and same_anc and cached >= 2 * BT + 6
    assert o["saved"][1] > o["saved"][0]
    got = o["tokens"][o["rid"]]
    assert got[:len(o["gen_before"])] == o["gen_before"]


def test_prompt_exceeding_allocation_is_counted_not_silent(runs):
    o = runs("prompt_exceeding_allocation")[1]
    assert o["warned"]
    assert o["truncated"] == BT
