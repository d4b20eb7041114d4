"""The windowed MoE, hybrid, VLM, SSM and audio families served by the
engine: ``TorchBackend`` against ``JaxBackend`` on the CPU, in float32.

``JaxBackend`` prefills these archs one request at a time through the
dense-cache ``prefill`` (zero patches for a VLM, zero frames for an audio
model) and writes its K/V into the paged pool; it decodes them with the
paged step of the dense body (no window, no SSM branch, no fusion norms)
and decodes no token for the SSM and audio archs. The port carries these
behaviours (``ROADMAP.md`` §3). Each scenario runs through
``torch_engine_pair``: two agents, each stalling on a tool call between
two decode segments, each stall forced to offload (and so to upload),
and one agent evicted after its first tokens, so that it re-prefills
through ``_prefill_one`` on the recompute path. The record holds the
tokens per rid, every engine counter, and after every engine step each
live request's ``cache_len``, ``_prefill_sig`` and the pool's K at its
written blocks (within ``LOGITS_ATOL`` = 1e-5). Beside them: the
reference's ``write_prefill`` of a K/V longer than the blocks held, the
backend built for every assigned arch, and the temporal gate at the
prompt lengths ``chip_smoke.py`` phase 13 serves.
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kvcache.paged import PagedKVCache as JPagedKVCache
from repro.models import model as JM
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.backend import TorchBackend
from repro_torch.kvcache.paged import PagedKVCache
from torch_engine_pair import torch_one_thread  # noqa: F401 (autouse)
from torch_engine_pair import JAX, TORCH, assert_same, record, run_both

import torch

ARCHS = ("mixtral_8x22b", "hymba_1_5b", "llava_next_mistral_7b",
         "mamba2_130m", "whisper_large_v3")
BT = 16
# the smoke configs' sliding window (Mixtral, Hymba and LLaVA)
WINDOW = 64


def family_cfg(P, arch):
    return dataclasses.replace(P.get_smoke_config(arch), dtype="float32")


def serve_two_agents(P, arch, prompt_len, segment):
    """Agents ``a`` (prompt_len tokens) and ``b`` (5 more), each decoding
    ``segment`` tokens, calling a tool, then ``segment`` more; every stall
    offloads at once; ``b`` is evicted after its first decode step."""
    cfg = family_cfg(P, arch)
    ecfg = P.EngineConfig.preset(
        "tokencake", gpu_blocks=48, host_blocks=48, max_running=8,
        temporal=P.TemporalConfig(score_threshold=-1.0,
                                  pressure_watermark=0.0))
    backend = P.backend(cfg, ecfg, P.A100_PCIE)
    eng = P.Engine(ecfg, P.A100_PCIE, backend=backend)
    rng = np.random.default_rng(0)
    prompts = {}
    for i, name in enumerate("ab"):
        prompts[name] = [int(t) for t in
                         rng.integers(0, 50000, prompt_len + 5 * i)]
        g = P.AppGraph(f"app{i}")
        g.add_agent(name, "w", len(prompts[name]),
                    decode_segments=[segment, segment],
                    func_calls=[P.FuncNode("tool", "web_search", 2.0)])
        eng.submit_app(g, eng.clock, prompt_tokens={0: prompts[name]})
    trace, offloaded, evicted, first_blocks = [], set(), None, {}
    for _ in range(400):
        if not eng.step():
            break
        live = {r.rid: r for r in eng.running}
        for rid, r in live.items():
            first_blocks.setdefault(rid, len(r.gpu_blocks))
        rb = next((r for r in live.values() if r.rid.endswith("/b")), None)
        if evicted is None and rb is not None and rb.context_len > len(
                prompts["b"]):
            eng._evict(rb, None)
            evicted = rb.rid
        for r in list(eng.stalled.values()):
            if r.rid not in offloaded and r.state == P.ReqState.STALLED:
                offloaded.add(r.rid)
                eng._start_offload(r)
        trace.append(dict(
            cache_len=dict(backend.cache_len),
            sig={rid: list(s) for rid, s in backend._prefill_sig.items()},
            k={rid: P.pool_k(backend, list(s))
               for rid, s in backend._prefill_sig.items() if s}))
    return record(eng, backend, trace=trace, evicted=evicted,
                  first_blocks=first_blocks, prompts=prompts)


# (arch, prompt tokens of agent a, tokens per decode segment): every arch
# within the smoke configs' 64-token window, then Mixtral and Hymba with
# prompts and decodes past it
CASES = [(arch, 20, 16) for arch in ARCHS] + [
    ("mixtral_8x22b", 70, 16), ("hymba_1_5b", 70, 16)]


@functools.lru_cache(maxsize=None)
def _runs(arch, prompt_len, segment):
    return run_both(functools.partial(serve_two_agents, arch=arch,
                                      prompt_len=prompt_len,
                                      segment=segment))


@pytest.mark.parametrize(
    "arch,prompt_len,segment", CASES,
    ids=[f"{a.split('_')[0]}-{p}" for a, p, _ in CASES])
def test_port_serves_the_family_as_jax_does(arch, prompt_len, segment):
    want, got = _runs(arch, prompt_len, segment)
    assert_same(want, got)
    m = got["metrics"]
    assert m["offloads"] >= 2 and m["uploads"] >= 2, m
    assert m["preemptions"] == 1 and got["evicted"], m
    assert got["logits"] == {}             # _prefill_one keeps none
    assert got["truncated"] == 0
    n_tokens = sum(len(t) for t in got["tokens"].values())
    if arch in ("mamba2_130m", "whisper_large_v3"):
        assert n_tokens == 0               # no paged decode, as in JAX
    else:
        assert n_tokens > 0
        assert set(got["tokens"]) == {f"app{i}#{i}/{n}"
                                      for i, n in enumerate("ab")}
    if arch == "llava_next_mistral_7b":
        # cache_len counts the text only; the prefill K/V also covers the
        # patches ahead of it and spans more blocks than the request holds
        patches = family_cfg(TORCH, arch).num_patch_tokens
        assert any(n * BT < patches + prompt_len
                   for n in got["first_blocks"].values())


def test_windowed_moe_within_its_window_matches_jax_dense_decode():
    """Mixtral-smoke within its window: agent ``a``'s tokens (offloaded and
    uploaded at its tool call) equal greedy decoding with the JAX
    package's dense-cache ``prefill`` and ``decode_step``."""
    want, got = _runs("mixtral_8x22b", 20, 16)
    prompt = got["prompts"]["a"]
    (rid,) = [r for r in got["tokens"] if r.endswith("/a")]
    tokens = got["tokens"][rid]
    assert len(prompt) + len(tokens) < WINDOW
    jcfg = family_cfg(JAX, "mixtral_8x22b")
    assert jcfg.sliding_window == WINDOW
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = [t % jcfg.vocab_size for t in prompt]
    _, cache = JM.prefill(jcfg, params,
                          {"tokens": jnp.asarray([toks], jnp.int32)},
                          cache_size=len(toks) + len(tokens) + 1)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    dense, tok, cl = [], toks[-1], len(toks)
    for _ in range(len(tokens)):
        logits, cache = step(params, cache, jnp.asarray([tok], jnp.int32),
                             jnp.int32(cl))
        tok = int(jnp.argmax(logits[0]))
        dense.append(tok)
        cl += 1
    assert tokens == dense == want["tokens"][rid]


@pytest.mark.parametrize("held", [2, 3], ids=["fewer-blocks", "all-blocks"])
def test_write_prefill_writes_the_blocks_the_request_holds(held):
    """A K/V of 40 positions (3 blocks) written for a request holding
    ``held`` blocks: JAX's scatter runs over the given blocks, so only the
    leading ones are written; the port's does the same, and leaves every
    other block alone."""
    cfg = family_cfg(TORCH, "llava_next_mistral_7b")
    shape = (cfg.num_layers, 40, cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(1)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    blocks = [5, 2, 7][:held]
    jc = JPagedKVCache(cfg, 8, BT, host_blocks=0, dtype=jnp.float32)
    jc.write_prefill(blocks, jnp.asarray(k), jnp.asarray(v))
    tc = PagedKVCache(cfg, 8, BT, host_blocks=0, dtype=torch.float32,
                      device="cpu")
    tc.write_prefill(blocks, torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    pad = np.zeros((shape[0], 48 - 40) + shape[2:], np.float32)
    want = np.concatenate([k, pad], 1).reshape(
        shape[0], 3, BT, *shape[2:])[:, :held]
    np.testing.assert_array_equal(tc.k.numpy()[:, blocks], want)
    others = [b for b in range(9) if b not in blocks]
    assert not tc.k.numpy()[:, others].any()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_backend_takes_every_assigned_arch(arch):
    """``TorchBackend`` constructs on the CPU for each assigned arch's smoke
    config, its pools shaped as ``PagedKVCache`` sizes them (one-element
    rows for an SSM arch, which has no KV heads)."""
    cfg = TORCH.get_smoke_config(arch)
    ecfg = TORCH.EngineConfig(mode="baseline", gpu_blocks=4, host_blocks=4)
    back = TorchBackend(cfg, ecfg, TORCH.A100_PCIE, device="cpu")
    hkv, d = max(cfg.num_kv_heads, 1), max(cfg.head_dim, 1)
    assert tuple(back.cache.k.shape) == (cfg.num_layers, 5, BT, hkv, d)
    assert (hkv, d) == ((1, 1) if cfg.arch_type == "ssm"
                        else (cfg.num_kv_heads, cfg.head_dim))


def gate_at_stalls(P, prompt_cap):
    """Two deep_research apps under ``chip_smoke.py`` phase 13's engine
    settings (2048 device and 1024 host blocks, the temporal gate's soft
    score and watermark open), prompts cut to ``prompt_cap`` and decode
    segments to 16, on the cost model alone (no data plane): the temporal
    gate's reason at each tool-call stall, the waiting requests it saw,
    and the offloads."""
    ecfg = P.EngineConfig.preset(
        "tokencake", gpu_blocks=2048, host_blocks=1024, max_running=8,
        temporal=P.TemporalConfig(score_threshold=-1.0,
                                  pressure_watermark=0.0))
    eng = P.Engine(ecfg, P.A100_PCIE)
    reasons, waiting = [], []
    gate = eng.temporal.should_offload

    def spy(req, wait, snap, scores):
        decision = gate(req, wait, snap, scores)
        reasons.append(decision.reason)
        waiting.append(len(wait))
        return decision

    eng.temporal.should_offload = spy
    for t, g in P.build_workload("deep_research", qps=2.0, n_apps=2,
                                 seed=0):
        for node in g.nodes.values():
            node.prompt_len = min(node.prompt_len, prompt_cap)
            node.decode_segments = [min(s, 16) for s in node.decode_segments]
        eng.submit_app(g, t)
    eng.run(max_time=1e5)
    return dict(reasons=reasons, waiting=waiting,
                offloads=eng.metrics["offloads"])


@pytest.mark.parametrize("prompt_cap", [128, 256, 512, 768, 1024, 1536])
def test_temporal_gate_finds_no_waiting_request_at_long_prompts(prompt_cap):
    """Why phase 13 offloads at every stall itself: with prompts cut to
    1024 tokens or more (Hymba's 1536 among them), no request waits when
    an agent stalls, so the gate (Alg. 1 l.8-10) finds no waiting fit and
    the engine offloads nothing; with shorter prompts requests wait and it
    offloads. Both packages decide alike."""
    want, got = run_both(functools.partial(gate_at_stalls,
                                           prompt_cap=prompt_cap))
    assert_same(want, got)
    assert got["reasons"]
    if prompt_cap >= 1024:
        assert set(got["reasons"]) == {"no waiting fit"}
        assert not any(got["waiting"]) and got["offloads"] == 0
    else:
        assert any(got["waiting"]) and got["offloads"] >= 1
