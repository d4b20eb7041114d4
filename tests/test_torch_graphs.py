"""The compiled serving steps (``repro_torch.models.graphs``): one CUDA
graph per bucket for the paged decode step, the prefill chunk and the
head, the counterpart of the JAX package's jitted steps.

On the CPU (where CUDA graphs do not exist and the backend runs its steps
eagerly):
* the bucket keys the graphs use, read off the backend's padded inputs,
  over the engine trace of ``test_torch_backend.py``: for an MoE arch
  every key equals the shape the JAX backend compiles its jitted steps
  for, call by call; for a dense arch the decode and head keys do, and
  each prefill call's replays follow the dense plan (replays of up to
  ``PREFILL_TOKENS`` positions of the rows whose suffix is left) and
  compute the positions the JAX backend's 32-token chunks compute;
* the dense plan and the lock step give the same K/V and last hidden
  rows on a mixed batch, in 10 replays against 63;
* ``paged_prefill_chunks`` keeps copies of the rows it returns, so a step
  that hands back one reused output buffer (as a replay does) gives the
  eager step's rows, under either plan;
* ``TorchBackend(device="cpu")`` builds no graph, and the launch counts
  of a capture add up once per replay.

Marked ``gpu`` (skipped without a CUDA device):
* one bf16 decode step and one prefill chunk at Qwen2.5-14B's widths (2
  layers, random weights from seed 0, B 8 rows of 256-token contexts
  through 16-page tables, a 32-token chunk) through the kernels agree with
  the same steps through the kernels' plain versions, swapped into
  ``ops`` by the test: within four bf16 steps of the largest output
  (2**-5 of it; the kernels differ from their plain versions by at most
  one bf16 step of each attention output, which two layers of bf16
  products and the head carry into the logits by a few steps), and the
  same argmax on every row whose top two logits are further apart than
  twice that;
* replayed decode, prefill and head outputs, and the K/V they write, equal
  the eager step's bit for bit across three buckets each, and again after
  an offload and an upload rewrote pool blocks between replays;
* so do the dense plan's buckets: a (1, 256) replay and the compacted
  replays of a mixed batch;
* so do a small MoE model's decode and prefill replays, in two buckets
  each;
* after N replays ``ops.launches`` holds N times the capture's counts;
* a capture that fails raises, naming the bucket, and runs nothing.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.model as JM
from repro.configs.base import ModelConfig as JModelConfig
from repro.core.backend import JaxBackend
from repro.core.costmodel import A100_PCIE as J_A100
from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.temporal import TemporalConfig as JTemporalConfig
from repro.data.workloads import build_workload as j_build_workload
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.backend import (PREFILL_CHUNK, PREFILL_TOKENS,
                                      TorchBackend, _bucket,
                                      paged_prefill_chunks)
from repro_torch.core.costmodel import A100_PCIE
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.temporal import TemporalConfig
from repro_torch.data.workloads import build_workload
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models import graphs as G
from repro_torch.models import model as M

TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")
CFG = ModelConfig(**TINY)
TINY_MOE = dict(TINY, name="tiny-moe-f32", arch_type="moe", num_experts=4,
                experts_per_token=2, moe_capacity_factor=1.25)
BT = A100_PCIE.block_tokens   # 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have "
                    "no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _shrink(workload):
    for _, g in workload:
        for n in g.nodes.values():
            n.prompt_len = min(n.prompt_len, 48)
            n.decode_segments = [min(s, 8) for s in n.decode_segments]
    return workload


def _engine_cfg(mk, temporal, kv_precision):
    return mk.preset("tokencake", gpu_blocks=96, host_blocks=128,
                     max_running=8,
                     temporal=temporal(score_threshold=-1.0,
                                       pressure_watermark=0.0,
                                       kv_precision=kv_precision))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _served_steps(tiny, kv_precision, monkeypatch):
    """The step calls of one engine trace (two shrunk deep_research apps,
    offloads forced) run by ``JaxBackend`` and by ``TorchBackend`` on the
    same weights: two lists of (bucket key, the prefill's q_pos or None),
    the JAX backend's first."""
    jax_calls = []
    for name, key in (
            ("paged_decode_step", lambda a: ("decode", *a[5].shape)),
            ("paged_prefill_step", lambda a: (
                "prefill", *a[4].shape, a[5].shape[1], a[7].shape[1])),
            ("head_logits", lambda a: ("head", a[2].shape[0]))):
        def record(*args, _fn=getattr(JM, name), _key=key):
            k = _key(args)
            jax_calls.append((k, np.asarray(args[6]) if k[0] == "prefill"
                              else None))
            return _fn(*args)
        monkeypatch.setattr(JM, name, record)
    jcfg = JModelConfig(**tiny)
    jecfg = _engine_cfg(JEngineConfig, JTemporalConfig, kv_precision)
    jback = JaxBackend(jcfg, jecfg, J_A100)
    jeng = JEngine(jecfg, J_A100, backend=jback)
    for t, g in _shrink(j_build_workload("deep_research", qps=2.0,
                                         n_apps=2, seed=0)):
        jeng.submit_app(g, t)
    jeng.run(max_time=5000)

    calls = []

    class Recording(G.EagerSteps):
        def _run(self, kind, params, pools, arrays):
            calls.append(((kind, *G.bucket_key(kind, arrays)),
                          arrays[2].copy() if kind == "prefill" else None))
            return super()._run(kind, params, pools, arrays)

        def head(self, params, h):
            calls.append((("head", *G.bucket_key("head", (h,))), None))
            return super().head(params, h)

    cfg = ModelConfig(**tiny)
    params = M.load_jax_params(jax.tree.map(np.asarray, jback.params),
                               "cpu")
    ecfg = _engine_cfg(EngineConfig, TemporalConfig, kv_precision)
    back = TorchBackend(cfg, ecfg, A100_PCIE, device="cpu", params=params)
    back.steps = Recording(cfg)
    eng = Engine(ecfg, A100_PCIE, backend=back)
    for t, g in _shrink(build_workload("deep_research", qps=2.0, n_apps=2,
                                       seed=0)):
        eng.submit_app(g, t)
    eng.run(max_time=5000)
    keys = [k for k, _ in calls]
    assert {k[0] for k in keys} == {"decode", "prefill", "head"}
    assert len({k for k in keys if k[0] == "decode"}) >= 2
    return jax_calls, calls


def _prefill_calls(calls):
    """The (key, q_pos) replays of each batched prefill call: the runs of
    consecutive prefill steps."""
    runs, prev = [], None
    for key, qpos in calls:
        if key[0] == "prefill":
            if prev != "prefill":
                runs.append([])
            runs[-1].append((key, qpos))
        prev = key[0]
    return runs


def _check_plan(key, qpos):
    """One replay of the dense plan: only rows with suffix left, at the
    front of the batch bucket; C = max(32, T // bb) while a row has more
    than 32 tokens left, else at most 32, so at most T positions for
    bb <= T / 32."""
    _, bb, c, _, pp = key
    counts = (qpos >= 0).sum(axis=1)
    rows = int((counts > 0).sum())
    assert (counts[:rows] > 0).all() and not counts[rows:].any(), key
    for row, n in zip(qpos, counts):
        assert (row[:n] >= 0).all() and (row[n:] < 0).all(), key
    assert bb == _bucket(rows), key
    cap = max(PREFILL_CHUNK, PREFILL_TOKENS // bb)
    if counts.max() > PREFILL_CHUNK:
        assert c == cap, key
    else:
        assert counts.max() <= c <= PREFILL_CHUNK, key
    assert bb * c <= PREFILL_TOKENS or c == PREFILL_CHUNK, key
    assert pp == (c - 1) // BT + 2, key


@pytest.mark.parametrize("kv_precision", ["fp16", "int8_host"])
def test_bucket_keys_match_the_jax_backends_compiled_shapes(
        kv_precision, monkeypatch):
    """A dense arch: decode and head keys equal the JAX backend's call for
    call; its prefill departs from the JAX backend's 32-token lock step
    on purpose, so each prefill call's replays follow the dense plan and
    compute the positions the JAX backend's chunks compute, in fewer
    replays."""
    jax_calls, calls = _served_steps(TINY, kv_precision, monkeypatch)
    assert [k for k, _ in calls if k[0] != "prefill"] == \
        [k for k, _ in jax_calls if k[0] != "prefill"]
    want, got = _prefill_calls(jax_calls), _prefill_calls(calls)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key, qpos in g:
            _check_plan(key, qpos)
        assert np.array_equal(
            np.sort(np.concatenate([q[q >= 0] for _, q in g])),
            np.sort(np.concatenate([q[q >= 0] for _, q in w])))
        assert len(g) <= len(w)
    assert sum(map(len, got)) < sum(map(len, want))


@pytest.mark.parametrize("kv_precision", ["fp16", "int8_host"])
def test_moe_bucket_keys_match_the_jax_backends_compiled_shapes(
        kv_precision, monkeypatch):
    """An MoE arch keeps the JAX backend's 32-token lock step: every key,
    prefill included, and every prefill's q_pos equal the JAX backend's
    call for call."""
    jax_calls, calls = _served_steps(TINY_MOE, kv_precision, monkeypatch)
    assert [k for k, _ in calls] == [k for k, _ in jax_calls]
    for (_, q), (_, w) in zip(calls, jax_calls):
        assert (q is None) == (w is None)
        assert q is None or np.array_equal(q, w)


def test_prefill_chunks_copy_rows_out_of_a_reused_output():
    params = M.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    # suffixes end in chunks 0, 1 and 2 of 8 tokens, one is empty, one
    # starts mid-block after a cached prefix
    entries = []
    for i, (n, cached) in enumerate(((5, 0), (13, 3), (20, 0), (4, 4))):
        blocks = [3 * i, 3 * i + 1, 3 * i + 2]
        toks = [int(t) for t in rng.integers(0, CFG.vocab_size, n)]
        entries.append((blocks, toks, cached))

    def run(reuse, budget):
        cache = PagedKVCache(CFG, 24, BT, dtype=torch.float32, device="cpu")
        step = functools.partial(G.EagerSteps(CFG).prefill, params, cache.k,
                                 cache.v)
        if reuse:
            eager, out = step, {}

            def step(*arrays):       # one output buffer a bucket, as a replay
                h = eager(*arrays)
                return out.setdefault(h.shape, torch.empty_like(h)).copy_(h)
        return paged_prefill_chunks(step, cache, entries, chunk=8,
                                    budget=budget), cache

    # the lock step, then replays of up to 32 positions of the rows left
    # ((4, 8), then (2, 16))
    for budget in (None, 32):
        (want, wc), (got, gc) = run(False, budget), run(True, budget)
        assert want[3] is None and got[3] is None
        for w, g in zip(want[:3], got[:3]):
            assert torch.equal(g, w)
        assert not torch.equal(want[0], want[2])
        assert torch.equal(wc.k, gc.k) and torch.equal(wc.v, gc.v)


def test_dense_prefill_plan_matches_the_lock_step_plan():
    """A mixed dense batch (suffixes of 2,000, 100 and 50 tokens, one
    empty, one of 19 tokens that starts mid-block after a 21-token cached
    prefix) through the backend's plan and through the MoE archs' 32-token
    lock step, from the same f32 pools and weights: the same K/V and last
    hidden rows within f32 rounding, 10 replays against 63 ((4, 64),
    (2, 128), 7 of (1, 256), the last 16 tokens in a (1, 32)), none over
    256 positions or carrying a row with no suffix left, and the backend's
    counters add up to the suffix tokens."""
    params = M.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    entries, o = [], 0
    for n, cached in ((2000, 0), (100, 0), (50, 0), (8, 8), (40, 21)):
        nb = -(-n // BT)
        entries.append((list(range(o, o + nb)), [int(t) for t in (
            rng.integers(0, CFG.vocab_size, n))], cached))
        o += nb
    ecfg = EngineConfig(mode="baseline", gpu_blocks=o + 4, host_blocks=4)
    runs = []
    for budget in (PREFILL_TOKENS, None):
        back = TorchBackend(CFG, ecfg, A100_PCIE, device="cpu",
                            params=params)
        gen = torch.Generator().manual_seed(6)
        for pool in (back.cache.k, back.cache.v):
            pool.copy_(torch.randn(pool.shape, generator=gen))
        calls, step = [], back.steps.prefill

        def record(*args, _step=step, _calls=calls):
            _calls.append([a.copy() for a in args[3:]])
            return _step(*args)
        back.steps.prefill = record
        rows = paged_prefill_chunks(back._prefill_step, back.cache, entries,
                                    budget=budget)
        runs.append((back, rows, calls))
    (plan, got, calls), (lock, want, lock_calls) = runs
    assert plan.prefill_budget == PREFILL_TOKENS
    assert got[3] is None and want[3] is None
    for g, w in zip(got, want):
        assert g is None or torch.allclose(g, w, atol=1e-5, rtol=1e-5)
    for a, b in ((plan.cache.k, lock.cache.k), (plan.cache.v, lock.cache.v)):
        torch.testing.assert_close(a[:, :-1], b[:, :-1], atol=1e-5,
                                   rtol=1e-5)
    assert [c[0].shape for c in calls] == [(4, 64), (2, 128)] + [
        (1, 256)] * 7 + [(1, 32)]
    assert len(lock_calls) == 63
    for tok, tables, qpos, wpages, wstart, wcount in calls:
        bb, c = tok.shape
        _check_plan(("prefill", bb, c, tables.shape[1], wpages.shape[1]),
                    qpos)
        assert tok.size <= PREFILL_TOKENS
    suffix = sum(len(t) - cached for _, t, cached in entries)
    assert plan.prefill_replays == 10 and lock.prefill_replays == 63
    assert plan.prefill_tokens == lock.prefill_tokens == suffix
    assert plan.prefill_slots == sum(c[0].size for c in calls)
    assert lock.prefill_slots == 63 * 8 * 32


def test_cpu_backend_builds_no_graph():
    ecfg = EngineConfig(mode="baseline", gpu_blocks=24, host_blocks=16)
    back = TorchBackend(CFG, ecfg, A100_PCIE, seed=0, device="cpu")
    assert type(back.steps) is G.EagerSteps
    with pytest.raises(ValueError, match="CUDA device"):
        G.StepGraphs(CFG, "cpu")


def test_bucket_key_reads_the_padded_shapes():
    z = functools.partial(np.zeros, dtype=np.int32)
    assert G.bucket_key("decode", (z(4), z((4, 8)), z(4), z(4), z(4))) \
        == (4, 8)
    assert G.bucket_key("prefill", (z((2, 16)), z((2, 4)), z((2, 16)),
                                    z((2, 3)), z(2), z(2))) == (2, 16, 4, 3)
    assert G.bucket_key("head", (torch.zeros(8, 64),)) == (8,)
    with pytest.raises(ValueError, match="unknown"):
        G.bucket_key("train", ())


def test_capture_launch_counts_add_once_per_replay():
    ops.reset_launches()
    with ops.capture_launches() as counts:
        with pytest.raises(RuntimeError, match="already"):
            with ops.capture_launches():
                pass
        counts["paged_attention"] += 2          # as _launch under capture
        counts["rope_kv_token_write"] += 2
    assert ops.launches["paged_attention"] == 0
    ops.add_launches(counts, 3)
    assert ops.launches["paged_attention"] == 6
    assert ops.launches["rope_kv_token_write"] == 6
    assert sum(ops.launches.values()) == 12
    ops.reset_launches()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# the kernel entries of the paged steps and their plain versions
PLAIN = {"rope_kv_token_write": R.rope_kv_token_write_ref,
         "paged_attention": R.paged_attention_ref,
         "rope_kv_chunk_write": R.rope_kv_chunk_write_ref,
         "paged_prefill_attention": R.paged_prefill_attention_ref}
STEP_REL = 2.0 ** -5
SB, SCTX, SC = 8, 256, 32       # rows, context, chunk of the serve's shape


def _serve_shape_inputs(vocab, nb):
    """Decode step and prefill chunk inputs of chip_smoke's serve shape."""
    p16 = SCTX // BT
    rng = np.random.default_rng(0)
    tables = rng.permutation(nb)[:SB * p16].reshape(SB, p16).astype(np.int32)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    dec = (i32(rng.integers(0, vocab, SB)), tables, i32([SCTX - 1] * SB),
           i32([SCTX] * SB), i32(tables[:, -1] * BT + BT - 1))
    wpages = np.full((SB, (SC - 1) // BT + 2), nb, np.int32)
    wpages[:, :2] = tables[:, -2:]
    pre = (i32(rng.integers(0, vocab, (SB, SC))), tables,
           i32(np.tile(SCTX - SC + np.arange(SC), (SB, 1))), wpages,
           i32([0] * SB), i32([SC] * SB))
    return dec, pre


@pytest.mark.gpu
def test_bf16_step_through_kernels_matches_plain_versions(dev, monkeypatch):
    cfg = dataclasses.replace(get_config("qwen2_5_14b_serving"),
                              num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    nb = SB * SCTX // BT
    shape = (cfg.num_layers, nb + 1, BT, cfg.num_kv_heads, cfg.head_dim)
    pools = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
             for _ in "kv"]
    dec, pre = _serve_shape_inputs(cfg.vocab_size, nb)
    eager = G.EagerSteps(cfg)
    steps = {
        "decode": lambda: eager.decode(params, *pools, *dec),
        "prefill": lambda: eager.head(params, eager.prefill(
            params, *pools, *pre)[:, -1])}
    for name, fn in steps.items():
        snap = [p.clone() for p in pools]
        got = fn().float()
        for p, s in zip(pools, snap):
            p.copy_(s)
        with monkeypatch.context() as m:
            for k, plain in PLAIN.items():
                m.setattr(ops, k, plain)
            want = fn().float()
        for p, s in zip(pools, snap):
            p.copy_(s)
        torch.cuda.synchronize()
        assert got.shape == (SB, cfg.vocab_size)
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        tol = STEP_REL * float(want.abs().max())
        top2 = want.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = got.argmax(-1) == want.argmax(-1)
        print(f"bf16 {name}: logits max abs err {err:.4g} (tolerance "
              f"{tol:.4g}); argmax agrees on {int(agree.sum())} of {SB} "
              f"rows ({int(clear.sum())} clear)")
        assert err <= tol, (name, err, tol)
        assert bool(agree[clear].all()), name


# a small bf16 model whose head dim (128) takes the tensor-core kernels
SMALL = ModelConfig(name="small-bf16", arch_type="dense", num_layers=2,
                    d_model=512, num_heads=4, num_kv_heads=2, d_ff=1024,
                    vocab_size=1024, dtype="bfloat16")
# its MoE counterpart: the experts' capacity comes from the bucket's shape
SMALL_MOE = dataclasses.replace(SMALL, name="small-moe-bf16",
                                arch_type="moe", d_ff=256, num_experts=16,
                                experts_per_token=4)
NBLK = 64


def _decode_args(rng, cache, bb, pb, b):
    tables = np.zeros((bb, pb), np.int32)
    tables[:] = rng.permutation(NBLK)[:bb * pb].reshape(bb, pb)
    toks = rng.integers(0, SMALL.vocab_size, bb).astype(np.int32)
    pos = np.zeros(bb, np.int32)
    lens = np.zeros(bb, np.int32)
    slots = np.full(bb, cache.scratch_slot, np.int32)
    for i in range(b):
        cl = int(rng.integers(1, pb * BT))
        pos[i], lens[i] = cl, cl + 1
        slots[i] = cache.slot_of(list(tables[i]), cl)
    return toks, tables, pos, lens, slots


def _prefill_args(rng, cache, bb, c, pb, b):
    tables = rng.permutation(NBLK)[:bb * pb].reshape(bb, pb).astype(np.int32)
    pp = (c - 1) // BT + 2
    tok = rng.integers(0, SMALL.vocab_size, (bb, c)).astype(np.int32)
    qpos = np.full((bb, c), -1, np.int32)
    wpages = np.full((bb, pp), cache.scratch_block, np.int32)
    wstart = np.zeros(bb, np.int32)
    wcount = np.zeros(bb, np.int32)
    for i in range(b):
        n = int(rng.integers(1, c + 1))
        cached = int(rng.integers(0, pb * BT - n + 1))
        qpos[i, :n] = cached + np.arange(n)
        wpages[i], wstart[i] = cache.write_window(list(tables[i]), cached, n,
                                                  pp)
        wcount[i] = n
    return tok, tables, qpos, wpages, wstart, wcount


def _small(dev, cfg=SMALL):
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    cache = PagedKVCache(cfg, NBLK, BT, host_blocks=16,
                         dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for pool in (cache.k, cache.v):
        pool.copy_(torch.randn(pool.shape, generator=gen, device=dev))
    return params, cache


@pytest.mark.gpu
def test_replays_equal_the_eager_step_across_buckets(dev):
    params, cache = _small(dev)
    eager, sg = G.EagerSteps(SMALL), G.StepGraphs(SMALL, dev)
    rng = np.random.default_rng(0)

    def same(kind, args):
        """The eager step and the graphs' call from the same pools give the
        same output and the same pools, bit for bit (but for the scratch
        block, which padded rows write in no set order)."""
        snap = [p.clone() for p in (cache.k, cache.v)]
        want = getattr(eager, kind)(params, cache.k, cache.v, *args).clone()
        want_kv = [p[:, :-1].clone() for p in (cache.k, cache.v)]
        for p, s in zip((cache.k, cache.v), snap):
            p.copy_(s)
        got = getattr(sg, kind)(params, cache.k, cache.v, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kind, args[1].shape)
        assert torch.equal(cache.k[:, :-1], want_kv[0]), kind
        assert torch.equal(cache.v[:, :-1], want_kv[1]), kind

    calls = []
    for bb, pb, b in ((1, 2, 1), (4, 4, 3), (8, 8, 8)):
        calls += [("decode", _decode_args(rng, cache, bb, pb, b))
                  for _ in range(2)]
    for bb, c, pb, b in ((1, 8, 2, 1), (2, 16, 4, 2), (8, 32, 8, 5)):
        calls += [("prefill", _prefill_args(rng, cache, bb, c, pb, b))
                  for _ in range(2)]
    for kind, args in calls:
        same(kind, args)
    heads = {}
    for bb in (1, 4, 8):
        for _ in range(2):
            h = torch.randn((bb, SMALL.d_model), device=dev).to(torch.bfloat16)
            want = eager.head(params, h)
            assert torch.equal(sg.head(params, h), want), bb
        heads[bb] = h
    assert sg.captures == {"decode": 3, "prefill": 3, "head": 3}
    assert sg.replays == {"decode": 6, "prefill": 6, "head": 6}

    # an offload and an upload rewrite pool blocks between replays: the
    # graphs read the pools they captured, as they are now
    cache.offload(list(range(8)), list(range(8)))
    cache.upload(list(range(8)), list(range(40, 48)))
    for kind, args in calls[1::2]:
        same(kind, args)
    for bb, h in heads.items():
        assert torch.equal(sg.head(params, h), eager.head(params, h)), bb
    assert sg.captures == {"decode": 3, "prefill": 3, "head": 3}

    # the graphs refuse pools they did not capture
    other = cache.k.clone()
    with pytest.raises(RuntimeError, match="not the tensors"):
        sg.decode(params, other, cache.v, *calls[0][1])


@pytest.mark.gpu
def test_prefill_plan_replays_equal_the_eager_step(dev):
    """The dense plan's buckets: a 256-token replay through a 64-page
    table, (1, 256, 64, 17), and the compacted replays of a mixed batch
    give the eager step's hidden rows and K/V bit for bit."""
    params, cache = _small(dev)
    eager, sg = G.EagerSteps(SMALL), G.StepGraphs(SMALL, dev)
    rng = np.random.default_rng(4)
    snap = [p.clone() for p in (cache.k, cache.v)]

    def restore():
        for p, s in zip((cache.k, cache.v), snap):
            p.copy_(s)

    args = _prefill_args(rng, cache, 1, 256, 64, 1)
    want = eager.prefill(params, cache.k, cache.v, *args).clone()
    want_kv = [p[:, :-1].clone() for p in (cache.k, cache.v)]
    restore()
    got = sg.prefill(params, cache.k, cache.v, *args)
    torch.cuda.synchronize()
    assert ("prefill", 1, 256, 64, 17) in sg.graphs
    assert torch.equal(got, want)
    assert torch.equal(cache.k[:, :-1], want_kv[0])
    assert torch.equal(cache.v[:, :-1], want_kv[1])

    # suffixes of 700, 100 and 40 tokens, one empty, one mid-block after a
    # cached prefix: a (4, 64) replay of four rows, a (2, 128) one of two,
    # then two (1, 256) replays of the long one
    entries, perm, o = [], rng.permutation(NBLK), 0
    for n, cached in ((700, 0), (100, 0), (40, 0), (5, 5), (30, 20)):
        nb = -(-n // BT)
        entries.append(([int(b) for b in perm[o:o + nb]], [int(t) for t in (
            rng.integers(0, SMALL.vocab_size, n))], cached))
        o += nb
    runs = []
    for steps in (eager, sg):
        restore()
        rows = paged_prefill_chunks(
            functools.partial(steps.prefill, params, cache.k, cache.v),
            cache, entries, budget=PREFILL_TOKENS)
        torch.cuda.synchronize()
        runs.append((rows, [p[:, :-1].clone() for p in (cache.k, cache.v)]))
    (want, want_kv), (got, got_kv) = runs
    assert got[3] is None and want[3] is None
    for w, g in zip(want, got):
        assert g is None or torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip(got_kv, want_kv))
    assert {k for k in sg.graphs if k[0] == "prefill"} == {
        ("prefill", 4, 64, 64, 5), ("prefill", 2, 128, 64, 9),
        ("prefill", 1, 256, 64, 17)}


@pytest.mark.gpu
def test_moe_replays_equal_the_eager_step(dev):
    """The MoE steps capture (their routing, sort and dispatch never wait
    for the host) and replay to the eager step's output and K/V bit for
    bit, in two buckets each, padded rows among them."""
    params, cache = _small(dev, SMALL_MOE)
    eager, sg = G.EagerSteps(SMALL_MOE), G.StepGraphs(SMALL_MOE, dev)
    rng = np.random.default_rng(2)
    calls = [("decode", _decode_args(rng, cache, bb, pb, b))
             for bb, pb, b in ((2, 2, 1), (8, 8, 6))]
    calls += [("prefill", _prefill_args(rng, cache, bb, c, pb, b))
              for bb, c, pb, b in ((1, 8, 2, 1), (8, 32, 8, 5))]
    for kind, args in calls * 2:
        snap = [p.clone() for p in (cache.k, cache.v)]
        want = getattr(eager, kind)(params, cache.k, cache.v, *args).clone()
        want_kv = [p[:, :-1].clone() for p in (cache.k, cache.v)]
        for p, s in zip((cache.k, cache.v), snap):
            p.copy_(s)
        got = getattr(sg, kind)(params, cache.k, cache.v, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kind, args[1].shape)
        assert torch.equal(cache.k[:, :-1], want_kv[0]), kind
        assert torch.equal(cache.v[:, :-1], want_kv[1]), kind
    assert sg.captures == {"decode": 2, "prefill": 2, "head": 0}
    assert sg.replays == {"decode": 4, "prefill": 4, "head": 0}


@pytest.mark.gpu
def test_replays_count_their_captures_launches(dev):
    params, cache = _small(dev)
    sg = G.StepGraphs(SMALL, dev)
    rng = np.random.default_rng(1)
    nl, n = SMALL.num_layers, 5
    for kind, args, want in (
            ("decode", _decode_args(rng, cache, 4, 4, 3),
             {"rope_kv_token_write": nl, "paged_attention": nl}),
            ("prefill", _prefill_args(rng, cache, 2, 16, 4, 2),
             {"rope_kv_chunk_write": nl, "paged_prefill_attention": nl})):
        ops.reset_launches()
        getattr(sg, kind)(params, cache.k, cache.v, *args)
        torch.cuda.synchronize()
        (g,) = [g for key, g in sg.graphs.items() if key[0] == kind]
        assert g.launches == want
        # the first call: the eager warm-up, then one replay
        assert {k: v for k, v in ops.launches.items() if v} == \
            {k: 2 * v for k, v in want.items()}
        ops.reset_launches()
        for _ in range(n):
            getattr(sg, kind)(params, cache.k, cache.v, *args)
        torch.cuda.synchronize()
        assert ops.launches == {k: n * want.get(k, 0) for k in ops.KERNELS}
    ops.reset_launches()


@pytest.mark.gpu
def test_a_failed_capture_raises_and_runs_nothing(dev, monkeypatch):
    params, cache = _small(dev)
    sg = G.StepGraphs(SMALL, dev)
    args = _decode_args(np.random.default_rng(2), cache, 2, 2, 2)
    real = ops.paged_attention

    def refuse_under_capture(*a):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_attention: refused under capture")
        return real(*a)

    monkeypatch.setattr(ops, "paged_attention", refuse_under_capture)
    with pytest.raises(RuntimeError,
                       match=r"decode step failed for bucket \(2, 2\).*"
                             r"paged_attention: refused"):
        sg.decode(params, cache.k, cache.v, *args)
    assert not sg.graphs and sg.replays["decode"] == 0
    monkeypatch.setattr(ops, "paged_attention", real)

    # the wrappers' caches refuse to be filled inside a capture, and a
    # launch captured outside ops.capture_launches raises
    q = torch.zeros((1, 4, 4), device=dev)
    pages = torch.zeros((3, BT, 1, 4), device=dev)
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lens = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="not made before"):
        with ops.capture_launches(), \
                torch.cuda.graph(torch.cuda.CUDAGraph()):
            ops.rope_freqs(6, 123.0, dev)
    with pytest.raises(RuntimeError, match="first seen"):
        with ops.capture_launches(), \
                torch.cuda.graph(torch.cuda.CUDAGraph()):
            ops.decode_splits(dev.index, 3, 5, BT, 2, 128, False)
    with pytest.raises(RuntimeError, match="outside ops.capture_launches"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            ops.paged_attention(q, pages, pages, table, lens)
