"""Host-tier promotion, its recompute election and workflow-aware prefetch
on real compute (``TestRecomputeElectionE2E`` and ``TestPromotionE2E`` of
``tests/test_promotion.py``, ``TestPrefetchE2E`` of
``tests/test_prefetch.py``), through ``TorchBackend`` on the CPU.

Each scenario runs on the same weights through ``repro.core.Engine`` with
``JaxBackend`` and through ``repro_torch.core.Engine`` with
``TorchBackend`` (``torch_engine_pair``): ``test_port_matches_jax`` holds
the port's tokens, engine counters (promotions, promoted blocks,
elections, prefetch hits, uploads, ``prefill_tokens``, wire bytes),
transfer ledger and prefill logits (1e-5) to the JAX package's; the
classes check the reference tests' assertions on the port, against its
own dense ``models.model.prefill`` and an unshared ``TorchBackend``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_engine_pair import torch_one_thread  # noqa: F401 (autouse)
from torch_engine_pair import (TINY, assert_same, offload_now, record,
                               run_both, run_out, shared_prompts, step,
                               submit_one)

BT = 16
TOL = dict(atol=2e-4, rtol=2e-4)


def fast_prefill(P):
    """Promoting still beats recomputing on an idle stream, but a modest
    backlog crosses over (``tests/test_promotion.py``)."""
    return dataclasses.replace(P.A100_PCIE, name="fast_prefill",
                               prefill_ms_per_token=0.05,
                               upload_ms_per_block=0.1)


def reference_tokens(P, cfg, platform, prompt, gpu_blocks, host_blocks):
    """``prompt`` decoded alone on a fresh baseline engine."""
    ecfg = P.EngineConfig.preset("baseline", gpu_blocks=gpu_blocks,
                                 host_blocks=host_blocks, max_running=8,
                                 sched_quantum=4)
    backend = P.backend(cfg, ecfg, platform)
    eng = P.Engine(ecfg, platform, backend=backend)
    submit_one(P, eng, prompt, decode_len=16)
    run_out(eng, 30)
    (toks,) = backend.generated.values()
    return list(toks)


def decode_out(eng, req, n):
    for _ in range(n):
        step(eng)
        if req.done:
            break


def transfers(eng):
    t = eng.transfers
    return dict(count=dict(t.count), wait_s=dict(t.wait_s),
                bytes=dict(t.bytes))


def recompute_election(P):
    cfg = P.ModelConfig(**TINY)
    plat = fast_prefill(P)
    ecfg = P.EngineConfig.preset("mooncake", gpu_blocks=128, host_blocks=64,
                                 max_running=8, sched_quantum=4,
                                 host_promotion=True,
                                 promotion_policy="cost")
    backend = P.backend(cfg, ecfg, plat)
    eng = P.Engine(ecfg, plat, backend=backend)
    prefix, sfx = shared_prompts(seed=13)
    prompt_a, prompt_b = prefix + sfx[0], prefix + sfx[1]
    ref_toks = reference_tokens(P, cfg, plat, prompt_b, 128, 64)
    submit_one(P, eng, prompt_a, decode_len=48, name="a")
    step(eng)
    (ra,) = eng.running
    offload_now(P, eng, ra)
    rng = np.random.default_rng(77)
    submit_one(P, eng, [int(t) for t in rng.integers(0, 50000, 20 * BT)],
               name="x")
    step(eng)
    rx = next(r for r in eng.running if r.rid.endswith("x"))
    offload_now(P, eng, rx, drain=False)
    submit_one(P, eng, prompt_b, decode_len=16, name="b")
    eng._process_events_until(eng.clock)
    eng.schedule_step()
    rb = next(r for r in eng.running if r.rid.endswith("b"))
    eng.clock += eng.execute_iteration()
    store = eng.prefix_store
    store.check_invariants()
    admitted = record(eng, backend, cached_b=rb.prefix_cached_tokens,
                      host_pins=len(eng.host.pins),
                      holds=len(store._promo_holds),
                      promos=len(store._promos),
                      dense_b=P.dense_logits(backend, prompt_b))
    decode_out(eng, rb, 60)
    store.check_invariants()
    return record(eng, backend, rid=rb.rid, admitted=admitted,
                  ref_toks=ref_toks, end_host_pins=len(eng.host.pins),
                  transfers=transfers(eng))


def promotion(P):
    cfg = P.ModelConfig(**TINY)
    plat = P.A100_PCIE
    ecfg = P.EngineConfig.preset("mooncake", gpu_blocks=64, host_blocks=32,
                                 max_running=8, sched_quantum=4,
                                 host_promotion=True)
    backend = P.backend(cfg, ecfg, plat)
    eng = P.Engine(ecfg, plat, backend=backend)
    prefix, sfx = shared_prompts(seed=7)
    prompt_a, prompt_b = prefix + sfx[0], prefix + sfx[1]
    ref_toks = reference_tokens(P, cfg, plat, prompt_b, 64, 32)
    submit_one(P, eng, prompt_a, decode_len=48, name="a")
    step(eng)
    (ra,) = eng.running
    offload_now(P, eng, ra)
    before = dict(eng.metrics)
    stream0 = eng.stream_free_at
    submit_one(P, eng, prompt_b, decode_len=16, name="b")
    step(eng)
    step(eng)
    rb = next(r for r in eng.running if r.rid.endswith("b"))
    admitted = record(eng, backend, before=before, stream=(
        stream0, eng.stream_free_at, plat.upload_time(3)),
        cached_b=rb.prefix_cached_tokens,
        cache_len_b=backend.cache_len[rb.rid],
        dense_b=P.dense_logits(backend, prompt_b))
    decode_out(eng, rb, 40)
    eng.prefix_store.check_invariants()
    return record(eng, backend, rid=rb.rid, prompt_b=prompt_b,
                  admitted=admitted, ref_toks=ref_toks,
                  transfers=transfers(eng))


def submit_chain(P, eng, prompts, decode_len=64, name=None):
    """Linear app n0 -> n1 -> ...: later nodes are unspawned while n0
    runs, the window the prefetch phase targets."""
    g = P.AppGraph(name or f"chain{len(eng.apps)}")
    prev = None
    for i, p in enumerate(prompts):
        prev = g.add_agent(f"n{i}", "w", len(p), decode_len=decode_len,
                           deps=[prev] if prev else [])
    return eng.submit_app(g, eng.clock,
                          prompt_tokens={i: list(p)
                                         for i, p in enumerate(prompts)})


def drain_stream(eng):
    eng.clock = max(eng.clock, eng.stream_free_at + 1e-9)
    eng._process_events_until(eng.clock)


def prefetch(P):
    cfg = P.ModelConfig(**TINY)
    plat = P.A100_PCIE
    ecfg = P.EngineConfig.preset(
        "mooncake", gpu_blocks=64, host_blocks=32, max_running=8,
        sched_quantum=4, host_promotion=True, promotion_policy="always",
        temporal=P.TemporalConfig(prefetch=True))
    backend = P.backend(cfg, ecfg, plat)
    eng = P.Engine(ecfg, plat, backend=backend)
    prefix, sfx = shared_prompts(seed=35)
    prompt_warm, prompt_b = prefix + sfx[0], prefix + sfx[1]
    ref_toks = reference_tokens(P, cfg, plat, prompt_b, 64, 32)
    submit_one(P, eng, prompt_warm, name="warm")
    step(eng)
    offload_now(P, eng, next(r for r in eng.running
                             if r.rid.endswith("warm")))
    rng = np.random.default_rng(135)
    head = [int(t) for t in rng.integers(0, 50000, 40)]
    submit_chain(P, eng, [head, prompt_b], decode_len=16, name="app")
    step(eng)
    issued = eng.metrics["prefetch_issued"]
    drain_stream(eng)
    rb = None
    for _ in range(60):
        step(eng)
        rb = next((r for a in eng.apps.values()
                   for r in a.node_request.values()
                   if r.rid.endswith("/n1")), None)
        if rb is not None and rb.prefill_pending == 0 \
                and rb.rid in backend.last_prefill_logits:
            break
    assert rb is not None
    admitted = record(
        eng, backend, issued=issued, cached_b=rb.prefix_cached_tokens,
        promo=(rb.promo_ready_at, rb.promo_tid),
        owned=any(t.owner == rb.rid
                  for t in eng.transfers.live() + eng.transfers.log),
        transfers=transfers(eng), dense_b=P.dense_logits(backend, prompt_b))
    decode_out(eng, rb, 60)
    eng.prefix_store.check_invariants()
    return record(eng, backend, rid=rb.rid, admitted=admitted,
                  ref_toks=ref_toks, end_host_pins=len(eng.host.pins))


SCENARIOS = {f.__name__: f for f in (recompute_election, promotion,
                                     prefetch)}


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


class TestRecomputeElectionE2E:
    """Two same-prefix requests under a backlogged stream: B elects
    recompute; its full prefill gives the dense logits, its decode the
    tokens of an unshared engine, and no host pin or hold leaks."""

    @pytest.fixture(scope="class")
    def o(self, runs):
        return runs("recompute_election")[1]

    def test_election_fired_and_nothing_promoted(self, o):
        m = o["admitted"]["metrics"]
        assert m["recompute_elections"] >= 1
        assert m["promotions"] == 0
        assert m["h2d_bytes"] == 0
        assert o["admitted"]["cached_b"] == 0

    def test_no_leaked_host_pins(self, o):
        a = o["admitted"]
        assert a["host_pins"] == a["holds"] == a["promos"] == 0

    def test_logits_equal_unshared_dense_prefill(self, o):
        a = o["admitted"]
        np.testing.assert_allclose(a["logits"][o["rid"]], a["dense_b"],
                                   **TOL)

    def test_decode_matches_reference(self, o):
        assert o["tokens"][o["rid"]][:16] == o["ref_toks"][:16]
        assert o["end_host_pins"] == 0


class TestPromotionE2E:
    """B admits after A's prefix was offloaded: its host hit is promoted
    H2D, it prefills only the suffix, its logits equal a dense prefill
    and its decode an unshared engine's."""

    @pytest.fixture(scope="class")
    def o(self, runs):
        return runs("promotion")[1]

    def test_promotion_metrics_and_stream_charge(self, o):
        a = o["admitted"]
        m = a["metrics"]
        assert m["promotions"] == 1
        assert m["promoted_blocks"] == 3
        assert m["promotion_saved_tokens"] == 3 * BT
        assert m["uploads"] == a["before"]["uploads"]
        stream0, stream1, upload3 = a["stream"]
        assert stream1 >= stream0 + upload3 - 1e-9

    def test_suffix_only_prefill(self, o):
        a = o["admitted"]
        assert a["cached_b"] == 3 * BT
        delta = a["metrics"]["prefill_tokens"] - a["before"]["prefill_tokens"]
        assert delta == len(o["prompt_b"]) - 3 * BT
        assert a["cache_len_b"] >= len(o["prompt_b"])

    def test_logits_equal_unshared_dense_prefill(self, o):
        a = o["admitted"]
        np.testing.assert_allclose(a["logits"][o["rid"]], a["dense_b"],
                                   **TOL)

    def test_decode_continues_identically(self, o):
        assert o["tokens"][o["rid"]][:16] == o["ref_toks"][:16]


class TestPrefetchE2E:
    """The prefetched agent's suffix-only prefill gives the dense logits,
    the requester paid no promotion stream wait, and its decode equals an
    unshared engine's."""

    @pytest.fixture(scope="class")
    def o(self, runs):
        return runs("prefetch")[1]

    def test_prefetch_fired_and_hit(self, o):
        a = o["admitted"]
        assert a["issued"] == 1
        assert a["cached_b"] == 3 * BT
        assert a["metrics"]["prefetch_hits"] == 3
        assert a["metrics"]["promotions"] == 0

    def test_zero_requester_stream_wait(self, o):
        a = o["admitted"]
        assert a["promo"] == (0.0, None)
        assert not a["owned"]
        assert a["transfers"]["count"]["prefetch"] == 1
        assert a["transfers"]["wait_s"]["promotion"] == 0.0

    def test_logits_equal_unshared_dense_prefill(self, o):
        a = o["admitted"]
        np.testing.assert_allclose(a["logits"][o["rid"]], a["dense_b"],
                                   **TOL)

    def test_decode_matches_reference(self, o):
        assert o["tokens"][o["rid"]][:16] == o["ref_toks"][:16]
        assert o["end_host_pins"] == 0
