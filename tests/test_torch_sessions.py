"""Multi-turn sessions on real compute through the port
(``test_turn2_tokens_identical_to_dense_recompute_jax`` of
``tests/test_sessions.py``), with ``TorchBackend`` on the CPU.

Turn 1 of a session ends, its KV is offloaded to the host tier, the
predictive warm brings it back ahead of turn 2, and turn 2 prefills only
its suffix. On the same weights, the port gives the JAX package's tokens,
engine and session counters and prefill logits (1e-5); its turn-2 tokens
equal a fresh dense recompute of the whole history on the port, and the
same two turns under ``session_policy="pin"`` (nothing leaves the device):
the round trip moves the bytes exactly.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_engine_pair import torch_one_thread  # noqa: F401 (autouse)
from torch_engine_pair import JAX, TORCH, assert_same

BT = 16
TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")


def prompts():
    rng = np.random.default_rng(23)
    p1 = [int(t) for t in rng.integers(0, 128, 3 * BT - 4)]
    user2 = [int(t) for t in rng.integers(0, 128, BT)]
    return p1, user2


def mk(P, sessions=True, policy="ttl"):
    cfg = P.ModelConfig(**TINY)
    kw = dict(gpu_blocks=96, host_blocks=64, max_running=8, sched_quantum=8,
              continuous_batching=True)
    if sessions:
        kw.update(sessions=True,
                  temporal=P.TemporalConfig(session_policy=policy))
    ecfg = P.EngineConfig.preset("tokencake", **kw)
    backend = P.backend(cfg, ecfg, P.A100_PCIE)
    eng = P.Engine(ecfg, P.A100_PCIE, backend=backend)
    return eng, backend, P.FrontDoor(eng, cache=None)


def two_turns(P, policy="ttl"):
    p1, user2 = prompts()
    eng, backend, fd = mk(P, policy=policy)
    g1 = fd.submit({"prompt": p1, "max_tokens": 8, "session_id": "s"})
    fd.drive()
    resp1 = list(backend.generated[g1.rid])
    state1 = eng.session_info("s")["state"]
    p2 = p1 + resp1 + user2
    before = eng.metrics["prefill_tokens"]
    g2 = fd.submit({"prompt": p2, "max_tokens": 8, "session_id": "s"},
                   arrival=g1.finish + 12.0)
    fd.drive()
    return dict(status=g2.status, resp1=resp1, state1=state1,
                turn2=list(backend.generated[g2.rid]), p2_len=len(p2),
                turn2_prefill=eng.metrics["prefill_tokens"] - before,
                metrics=dict(eng.metrics),
                sessions=dict(eng.session_metrics),
                logits=dict(backend.last_prefill_logits),
                report=fd.report(), p2=p2)


def dense_recompute(P, p2):
    eng, backend, fd = mk(P, sessions=False)
    ref = fd.submit({"prompt": p2, "max_tokens": 8})
    fd.drive()
    return list(backend.generated[ref.rid])


@pytest.fixture(scope="module")
def runs():
    return {(P.name, pol): two_turns(P, pol) for P in (JAX, TORCH)
            for pol in ("ttl", "pin")}


@pytest.mark.parametrize("policy", ["ttl", "pin"])
def test_port_matches_jax(runs, policy):
    assert_same(runs["jax", policy], runs["torch", policy])


def test_turn2_tokens_identical_to_dense_recompute(runs):
    o = runs["torch", "ttl"]
    assert len(o["resp1"]) == 8
    assert o["state1"] in ("offloading", "offloaded")
    assert o["status"] == "finished"
    assert o["sessions"]["session_warms"] == 1
    assert o["turn2_prefill"] < o["p2_len"]
    assert o["turn2"] == dense_recompute(TORCH, o["p2"])
    assert len(o["turn2"]) == 8


def test_offload_and_warm_equal_pinned_session(runs):
    ttl, pin = runs["torch", "ttl"], runs["torch", "pin"]
    assert ttl["sessions"]["session_offloads"] >= 1
    assert pin["sessions"]["session_offloads"] == 0
    assert pin["sessions"]["session_warms"] == 0
    assert pin["turn2_prefill"] == ttl["turn2_prefill"]
    assert (ttl["resp1"], ttl["turn2"]) == (pin["resp1"], pin["turn2"])
