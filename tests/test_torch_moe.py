"""The port's MoE FFN (``repro_torch.models.moe``) and MoE serving against
the JAX package, on the CPU in float32.

* ``moe_ffn`` against ``repro.models.moe.moe_ffn`` on the same weights and
  numpy inputs, with and without ``pad_mask``, at capacity factor 8 (no
  entry dropped) and at 0.5 (entries dropped): the routes (top-k expert
  ids) are equal, the dropped (token, slot) entries are the reference's
  (the first ``capacity`` entries of each expert in token·k + slot order
  are kept), and the outputs agree to 1e-5 (atol and rtol: the products
  sum in another order). The auxiliary loss agrees to 1e-5 too.
* The pad invariance of ``test_moe_paged.py``: padded rows under the mask
  change nothing and come out exactly zero; an all-valid mask equals no
  mask bit for bit.
* Batched and single-request paged MoE decode through
  ``TorchBackend(device="cpu")`` give the tokens of the port's own
  dense-cache ``prefill`` / ``decode_step``, token for token.
* The engine trace of ``test_torch_backend.py`` on a tiny MoE model: the
  same tokens per request and the same offloads as ``JaxBackend`` on the
  same weights, with an fp16 and with an int8 host tier.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_smoke_config as jget_smoke
from repro.core.backend import JaxBackend
from repro.core.costmodel import A100_PCIE as J_A100
from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.temporal import TemporalConfig as JTemporalConfig
from repro.data.workloads import build_workload as j_build_workload
from repro.models import moe as JMOE
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import TorchBackend
from repro_torch.core.costmodel import A100_PCIE
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.graph import AppGraph
from repro_torch.core.request import Request
from repro_torch.core.temporal import TemporalConfig
from repro_torch.data.workloads import build_workload
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

# the tiny MoE model of test_moe_paged.py (capacity factor 8: no drops)
TINY = dict(name="tiny-moe-f32", arch_type="moe", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32", num_experts=4, experts_per_token=2,
            moe_capacity_factor=8.0)
CFG = ModelConfig(**TINY)
TOL = dict(atol=1e-5, rtol=1e-5)
WIDTHS = {"tiny": JModelConfig(**TINY),
          "kimi-smoke": dataclasses.replace(jget_smoke("kimi_k2_1t_a32b"),
                                            dtype="float32"),
          "mixtral-smoke": dataclasses.replace(jget_smoke("mixtral_8x22b"),
                                               dtype="float32")}


def _layer(jcfg, seed=4):
    """One layer's expert params from the JAX init: (JAX, port)."""
    jlp = {k: v[0] for k, v in JMOE.init_moe(
        jcfg, jax.random.PRNGKey(seed), 1, jnp.float32).items()}
    return jlp, {k: torch.from_numpy(np.array(v)) for k, v in jlp.items()}


def _inputs(d, seed, masked, b=2, s=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = rng.random((b, s)) < 0.7 if masked else None
    return x, mask


def _jax_routes(jcfg, jlp, x):
    """The reference router's top-k expert ids (T, k), by the lines of
    ``repro.models.moe.moe_ffn``."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jlp["wr"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.experts_per_token)[1])


def _kept(routes, valid, e, cap):
    """Which (token, slot) entries the reference keeps: per expert, the
    first ``cap`` real entries in token·k + slot order."""
    seen = np.zeros(e, int)
    kept = np.zeros(routes.shape, bool)
    for t, row in enumerate(routes):
        for j, ex in enumerate(row):
            if valid[t]:
                kept[t, j] = seen[ex] < cap
                seen[ex] += 1
    return kept


@pytest.mark.parametrize("factor", [8.0, 0.5], ids=["no-drop", "drop"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_moe_ffn_matches_jax(width, masked, factor):
    jcfg = dataclasses.replace(WIDTHS[width], moe_capacity_factor=factor)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jlp, lp = _layer(jcfg)
    x, mask = _inputs(jcfg.d_model, seed=1, masked=masked)
    t, e, k = x.shape[0] * x.shape[1], cfg.num_experts, cfg.experts_per_token
    valid = np.ones(t, bool) if mask is None else mask.reshape(t)
    xt = torch.from_numpy(x)
    tmask = None if mask is None else torch.from_numpy(mask)

    want, _ = JMOE.moe_ffn(jcfg, jlp, jnp.asarray(x),
                           None if mask is None else jnp.asarray(mask))
    got = MOE.moe_ffn(cfg, lp, xt, tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got.reshape(t, -1)[~valid].any()      # padded rows are 0

    # the same routes, and the reference's dropped entries
    routes = _jax_routes(jcfg, jlp, x)
    _, _, _, flat_e = MOE.route(cfg, lp, xt.reshape(t, -1),
                                None if mask is None else tmask.reshape(t))
    np.testing.assert_array_equal(
        flat_e.numpy().reshape(t, k), np.where(valid[:, None], routes, e))
    cap = MOE.capacity(t, cfg)
    assert cap == JMOE.capacity(t, jcfg)
    sort_idx, slot = MOE.dispatch(cfg, flat_e, cap)
    kept = torch.zeros(t * k, dtype=torch.bool).index_copy_(
        0, sort_idx, slot < e * cap).numpy().reshape(t, k)
    want_kept = _kept(routes, valid, e, cap)
    np.testing.assert_array_equal(kept, want_kept)
    dropped = int((valid[:, None] & ~want_kept).sum())
    assert (dropped > 0) == (factor < 1.0), dropped


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_aux_loss_matches_jax(masked):
    jcfg = WIDTHS["kimi-smoke"]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jlp, lp = _layer(jcfg, seed=2)
    x, mask = _inputs(jcfg.d_model, seed=3, masked=masked)
    _, want = JMOE.moe_ffn(jcfg, jlp, jnp.asarray(x),
                           None if mask is None else jnp.asarray(mask))
    got = MOE.aux_loss(cfg, lp, torch.from_numpy(x),
                       None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def _port_layer(seed):
    _, lp = _layer(WIDTHS["tiny"], seed=4)
    rng = np.random.default_rng(seed)
    return lp, rng


def test_moe_ffn_pad_invariance_and_zero_padded_rows():
    lp, rng = _port_layer(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    y_ref = MOE.moe_ffn(CFG, lp, x)
    # embedded in a larger padded bucket; garbage rows would crowd real
    # tokens out of expert capacity without the mask
    xp = torch.full((4, 8, 64), 99.0)
    xp[:2, :5] = x
    xp[:2, 5:] = 0.0
    mask = torch.zeros((4, 8), dtype=torch.bool)
    mask[:2, :5] = True
    y_pad = MOE.moe_ffn(CFG, lp, xp, pad_mask=mask)
    assert torch.equal(y_pad[:2, :5], y_ref)
    assert not y_pad[2:].any() and not y_pad[:2, 5:].any()


def test_moe_ffn_all_valid_mask_matches_no_mask_bitwise():
    lp, rng = _port_layer(2)
    x = torch.from_numpy(rng.standard_normal((3, 7, 64)).astype(np.float32))
    y0 = MOE.moe_ffn(CFG, lp, x)
    y1 = MOE.moe_ffn(CFG, lp, x, pad_mask=torch.ones((3, 7),
                                                     dtype=torch.bool))
    assert torch.equal(y0, y1)


# ---------------------------------------------------------------------------
# paged MoE decode through TorchBackend against the dense-cache path
# ---------------------------------------------------------------------------

def mk_backend(gpu_blocks=24, host_blocks=16):
    ecfg = EngineConfig(mode="baseline", gpu_blocks=gpu_blocks,
                        host_blocks=host_blocks)
    return TorchBackend(CFG, ecfg, A100_PCIE, seed=4, device="cpu")


def mk_req(rid, prompt, blocks):
    g = AppGraph("t")
    node = g.add_agent("a", "worker", len(prompt), decode_len=64)
    r = Request(rid=rid, app_id="app", node=node, graph=g, arrival=0.0,
                prompt_tokens=list(prompt))
    r.gpu_blocks_by_device[0] = list(blocks)
    return r


def dense_reference_tokens(backend, prompt, steps):
    cfg, params = backend.cfg, backend.params
    total = len(prompt) + steps + 1
    batch = {"tokens": torch.tensor([list(prompt)], dtype=torch.int32)}
    _, cache = M.prefill(cfg, params, batch, cache_size=total)
    out, tok, cl = [], prompt[-1], len(prompt)
    for _ in range(steps):
        logits, cache = M.decode_step(cfg, params, cache,
                                      torch.tensor([tok], dtype=torch.int32),
                                      cl)
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        cl += 1
    return out


def test_moe_batched_paged_decode_matches_dense_reference():
    """Two MoE requests of unequal length: the batched paged prefill
    (bucket-padded suffix chunks) and batched paged decode reproduce the
    per-request dense-cache path exactly."""
    backend = mk_backend()
    rng = np.random.default_rng(3)
    p1 = [int(t) for t in rng.integers(0, CFG.vocab_size, 14)]
    p2 = [int(t) for t in rng.integers(0, CFG.vocab_size, 30)]
    steps = 8
    r1 = mk_req("r1", p1, blocks=[3, 4])
    r2 = mk_req("r2", p2, blocks=[7, 8, 9])
    for _ in range(steps):
        backend.decode([r1, r2])
    assert backend.generated["r1"] == dense_reference_tokens(backend, p1,
                                                             steps)
    assert backend.generated["r2"] == dense_reference_tokens(backend, p2,
                                                             steps)


def test_moe_single_request_paged_decode_matches_dense_reference():
    """A lone short request: rows of pure padding in both the prefill
    chunks and the decode batch."""
    backend = mk_backend()
    rng = np.random.default_rng(9)
    prompt = [int(t) for t in rng.integers(0, CFG.vocab_size, 10)]
    r = mk_req("r", prompt, blocks=[5, 6])
    steps = 6
    for _ in range(steps):
        backend.decode([r])
    assert backend.generated["r"] == dense_reference_tokens(backend, prompt,
                                                            steps)


# ---------------------------------------------------------------------------
# the engine trace against JaxBackend
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("kv_precision", ["fp16", "int8_host"])
def test_moe_engine_trace_matches_jax_token_for_token(kv_precision):
    jcfg = JModelConfig(**TINY)
    jecfg = _engine_cfg(JEngineConfig, JTemporalConfig, kv_precision)
    jback = JaxBackend(jcfg, jecfg, J_A100)
    jeng = JEngine(jecfg, J_A100, backend=jback)
    for t, g in _shrink(j_build_workload("deep_research", qps=2.0,
                                         n_apps=2, seed=0)):
        jeng.submit_app(g, t)
    jrep = jeng.run(max_time=5000)

    params = M.load_jax_params(jax.tree.map(np.asarray, jback.params),
                               "cpu")
    ecfg = _engine_cfg(EngineConfig, TemporalConfig, kv_precision)
    back = TorchBackend(CFG, ecfg, A100_PCIE, device="cpu", params=params)
    eng = Engine(ecfg, A100_PCIE, backend=back)
    for t, g in _shrink(build_workload("deep_research", qps=2.0, n_apps=2,
                                       seed=0)):
        eng.submit_app(g, t)
    rep = eng.run(max_time=5000)

    assert rep["apps_finished"] == jrep["apps_finished"] == 2
    assert rep["offloads"] >= 1
    assert rep["offloads"] == jrep["offloads"]
    assert rep["uploads"] == jrep["uploads"]
    assert rep["decoded_tokens"] == jrep["decoded_tokens"] > 0
    assert rep["truncated_prompt_tokens"] == 0
    assert back.generated.keys() == jback.generated.keys()
    for rid, toks in jback.generated.items():
        assert back.generated[rid] == toks, rid
