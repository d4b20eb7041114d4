"""The port's Whisper-style encoder-decoder (``repro_torch.models.encdec``)
and the layers it adds (LayerNorm, the GELU MLP, sinusoidal positions)
against ``repro.models`` on the same weights and inputs (numpy, from a
seed), in float32 on the CPU.

Tolerances: 1e-6 for the layers alone (the sinusoids plus one float32
step of their angle, which the two packages' exp may move); 2e-5 for the
encoder, the
cross-attention K/V, the teacher-forced decoder and the prefill and
decode steps, whose two layers of float32 products and softmaxes sum in
another order in each package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jget_smoke
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import model as M

LAYER_TOL = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=2e-5, rtol=2e-5)


def _configs(dtype="float32"):
    jcfg = dataclasses.replace(jget_smoke("whisper_large_v3"), dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _weights(jcfg, rng):
    """The JAX init's weights, with the LayerNorm gains and every bias
    (ones and zeros there) randomised so that the comparison reads them."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("w", "b", "b1", "b2", "bq", "bk", "bv"):
                t[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    walk(tree)
    return tree


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    w, b = (rng.standard_normal(48).astype(np.float32) for _ in "wb")
    _close(L.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           LAYER_TOL, "layer_norm")

    lp = {"w1": rng.standard_normal((48, 96)) * 0.2,
          "b1": rng.standard_normal(96) * 0.5,
          "w2": rng.standard_normal((96, 48)) * 0.1,
          "b2": rng.standard_normal(48) * 0.5}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    _close(L.mlp({k: torch.from_numpy(v) for k, v in lp.items()},
                 torch.from_numpy(x), gelu=True),
           JL.mlp({k: jnp.asarray(v) for k, v in lp.items()},
                  jnp.asarray(x), gelu=True), LAYER_TOL, "GELU mlp")

    # XLA's float32 exp and torch's differ by one step on some inverse
    # timescales, which moves an angle t by |t| 2**-23 at most: 1e-6 plus
    # that, element by element
    inv = np.exp(-np.log(10000) / 31 * np.arange(32))
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    for what, got, want, t in (
            ("sinusoids", ED.sinusoids(37, 64), JED.sinusoids(37, 64),
             np.arange(37)[:, None] * inv),
            ("position_embed", ED.position_embed(torch.from_numpy(pos), 64),
             JED.position_embed(jnp.asarray(pos), 64),
             pos[..., None] * inv)):
        bound = 1e-6 + np.concatenate([t, t], axis=-1) * 2.0 ** -23
        diff = np.abs(got.numpy() - np.asarray(want))
        assert (diff <= bound).all(), (what, diff.max())


def test_encoder_and_decoder_match_jax():
    jcfg, cfg = _configs()
    rng = np.random.default_rng(2)
    tree = _weights(jcfg, rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = M.load_jax_params(tree, "cpu")
    b, s, f = 2, 12, cfg.encoder_frames
    frames = (0.5 * rng.standard_normal((b, f, cfg.d_model))).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)

    j_enc = JED.encode(jcfg, jp, jnp.asarray(frames))
    t_enc = ED.encode(cfg, tp, torch.from_numpy(frames))
    _close(t_enc, j_enc, TOL, "encode")
    enc = np.array(j_enc)               # both decoders read the same input

    jk, jv = JED.cross_kv(jcfg, jp, jnp.asarray(enc))
    tk, tv = ED.cross_kv(cfg, tp, torch.from_numpy(enc))
    _close(tk, jk, TOL, "cross k")
    _close(tv, jv, TOL, "cross v")

    x = tree["embed"][toks]
    pos = np.arange(s)[None, :]
    _close(ED.decode_forward(cfg, tp, torch.from_numpy(x),
                             torch.from_numpy(pos), torch.from_numpy(enc)),
           JED.decode_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              jnp.asarray(enc)), TOL, "decode_forward")

    size, steps = s + 6, 4
    batch = {"tokens": toks, "frames": frames}
    jl, jc = JM.prefill(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, size)
    tl, tc = M.prefill(cfg, tp, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, size)
    _close(tl, jl, TOL, "prefill logits")
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    for k in jc:
        _close(tc[k], jc[k], TOL, f"prefill cache {k}")
    assert {k: (tuple(t.shape), t.dtype) for k, t in tc.items()} == \
        M.cache_specs(cfg, b, size, frames=f)

    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for step in range(steps):
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(nxt),
                                jnp.int32(s + step))
        tl, tc2 = M.decode_step(cfg, tp, tc, torch.from_numpy(nxt), s + step)
        assert tc2 is tc                  # the cache is written in place
        _close(tl, jl, TOL, f"decode {step} logits")
        for k in ("k", "v"):
            _close(tc[k], jc[k], TOL, f"decode {step} cache {k}")
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_audio_param_tree_and_cache_specs_match_jax():
    """bf16 Whisper: ``param_specs`` and ``init_params`` give every leaf of
    the JAX tree (``encoder`` / ``decoder`` / ``enc_ln_post``, no
    ``layers``) its shape and dtype; ``cache_specs`` with and without
    ``frames`` equals JAX's, and so does ``cache_bytes``."""
    jcfg, cfg = _configs("bfloat16")
    jspecs = {"/".join(p.key for p in path): (a.shape, a.dtype.name)
              for path, a in jax.tree_util.tree_flatten_with_path(
                  JM.param_specs(jcfg))[0]}
    specs = {k: (shape, str(dt).split(".")[-1])
             for k, (shape, dt) in M.param_specs(cfg).items()}
    assert specs == jspecs
    assert not any(k.startswith("layers/") for k in specs)
    drawn = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert M.param_count(drawn) == sum(int(np.prod(s)) for s, _ in
                                       jspecs.values())
    for frames in (0, 7):
        want = JM.cache_specs(jcfg, 3, 40, frames=frames)
        got = M.cache_specs(cfg, 3, 40, frames=frames)
        assert set(got) == set(want)
        for k, (shape, dt) in got.items():
            assert shape == want[k].shape, (frames, k)
            assert str(dt).split(".")[-1] == want[k].dtype.name, (frames, k)
    assert M.cache_bytes(cfg, 3, 40) == JM.cache_bytes(jcfg, 3, 40)
