"""Mamba2 SSD (state-space duality) mixer. [arXiv:2405.21060]

The counterpart of ``repro.models.ssm``. Within a chunk of Q tokens the
output is a masked quadratic term; across chunks a (H, P, N) state is
carried with a per-step scalar decay. The JAX model computes the chunked
scan in plain ``jnp`` with a ``lax.scan`` over chunks that mirrors the
Pallas kernel's grid. Here serving runs the scan through the kernel,
``ops.ssd_scan`` (B14), which on the CPU runs its plain version, the
token-sequential recurrence; training runs :func:`ssd_chunk_scan_plain`,
the JAX function step for step, since B14 has no backward (neither has
the Pallas kernel). All give the same function: the chunking only
reorders sums.

The SSM cache of a layer is fixed-size: the last ``W - 1`` inputs of the
causal conv (B, W-1, conv_dim) and the state (B, H, P, N) float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def proj_dims(cfg):
    """(d_inner, d_proj, conv_dim): the in-projection packs z, x, B, C and
    dt (one group), and the conv runs over [x, B, C]."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state, cfg.ssm_heads
    return d_inner, 2 * d_inner + 2 * n + h, d_inner + 2 * n


def init_ssm(cfg, generator, n_layers: int, dtype, device):
    """Stacked mixer params at the JAX package's scales; ``A_log``, ``D``
    and ``dt_bias`` are float32 whatever ``dtype`` is."""
    d = cfg.d_model
    d_inner, d_proj, conv_dim = proj_dims(cfg)
    h, w = cfg.ssm_heads, cfg.ssm_conv_width

    def init(shape, scale=None):
        return L.stacked_init(n_layers, shape, dtype, generator, device,
                              scale)

    f32 = dict(dtype=torch.float32, device=device)
    dt0 = torch.linspace(1e-3, 0.1, h, **f32)
    return {
        "in_proj": init((d, d_proj)),
        "conv_w": init((w, conv_dim), scale=1.0 / math.sqrt(w)),
        "conv_b": torch.zeros((n_layers, conv_dim), dtype=dtype,
                              device=device),
        "A_log": torch.log(torch.arange(1, h + 1, **f32)).repeat(n_layers, 1),
        "D": torch.ones((n_layers, h), **f32),
        "dt_bias": torch.log(torch.expm1(dt0)).repeat(n_layers, 1),
        "ssm_norm": torch.zeros((n_layers, d_inner), dtype=dtype,
                                device=device),
        "out_proj": init((d_inner, d), scale=1.0 / math.sqrt(
            d_inner * max(cfg.num_layers, 1))),
    }


def _split_proj(cfg, zxbcdt):
    d_inner, _, _ = proj_dims(cfg)
    n, h = cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)


def _causal_conv(cfg, lp, u, cache=None):
    """Depthwise causal conv of width W over u (B, S, C), with the last
    W - 1 inputs of the previous call in ``cache`` (zeros if None).
    Returns (silu(conv) in u's dtype, new cache (B, W-1, C))."""
    w = cfg.ssm_conv_width
    if cache is None:
        cache = torch.zeros(u.shape[:1] + (w - 1,) + u.shape[2:],
                            dtype=u.dtype, device=u.device)
    full = torch.cat([cache, u], dim=1)
    s = u.shape[1]
    out = sum(full[:, i:i + s] * lp["conv_w"][i] for i in range(w))
    out = out + lp["conv_b"]
    return F.silu(out.float()).to(u.dtype), full[:, -(w - 1):]


def _ssd_chunk_scan(cfg, x, dt, a, b, c):
    """Chunked SSD core from a zero state, through ``ops.ssd_scan``.

    x (B, S, H, P); dt, a (B, S, H) float32; b, c (B, S, N) float32. S is
    padded with zeros to a multiple of Q = min(ssm_chunk, S), as the JAX
    model pads it: zero ``a`` and ``dt`` leave the carried state as it is,
    so the final state is that of the last real token. Returns y
    (B, S, H, P) float32 and the final state (B, H, P, N) float32.
    """
    s = x.shape[1]
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    args = [t.contiguous() for t in (x, dt, a, b, c)]
    if pad:
        args = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in args]
    y, state = ops.ssd_scan(*args, chunk=q)
    return (y[:, :s] if pad else y), state


def ssd_chunk_scan_plain(cfg, x, dt, a, b, c):
    """The chunked SSD scan from a zero state in plain, differentiable
    PyTorch: ``repro.models.ssm._ssd_chunk_scan`` with a Python loop over
    chunks. Each chunk adds its masked quadratic term and the carried
    state's term, then decays the state and adds its contribution. Same
    arguments and results as :func:`_ssd_chunk_scan`."""
    bsz, s, h, p = x.shape
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        x, dt, a, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                          for t in (x, dt, a, b, c))
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    state = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for i in range(0, x.shape[1], q):
        xq, dtq, aq, bq, cq = (t[:, i:i + q] for t in (x, dt, a, b, c))
        xq = xq.float()
        a_cum = aq.cumsum(dim=1)                             # (B, Q, H)
        # L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j; clamped before
        # the exp, so the upper triangle's large diffs cannot overflow
        # into the gradient through the where
        diff = a_cum[:, :, None, :] - a_cum[:, None, :, :]   # (B, Q, Q, H)
        diff = torch.where(mask, diff, diff.new_full((), -60.0))
        decay = torch.where(mask, torch.exp(diff), diff.new_zeros(()))
        scores = torch.einsum("bin,bjn->bij", cq, bq)
        w = scores[..., None] * decay * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
        y_inter = torch.einsum("bin,bhpn->bihp", cq, state) \
            * torch.exp(a_cum)[..., None]
        rem = torch.exp(a_cum[:, -1:, :] - a_cum)
        contrib = torch.einsum("bjh,bjn,bjhp->bhpn", dtq * rem, bq, xq)
        state = state * torch.exp(a_cum[:, -1])[..., None, None] + contrib
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return (y[:, :s] if pad else y), state


def _gated_out(cfg, lp, y, z, xh, x_dtype):
    """Skip term D x, gated RMSNorm (mamba2) and the out-projection."""
    bsz, s = y.shape[:2]
    d_inner, _, _ = proj_dims(cfg)
    y = y + lp["D"][:, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x_dtype)
    y = L.rms_norm(y * F.silu(z.float()).to(x_dtype), lp["ssm_norm"])
    return y @ lp["out_proj"]


def ssm_mixer(cfg, lp, x, state=None, plain: bool = False):
    """Mamba2 mixer over a sequence x (B, S, d_model) from a zero state.
    The scan runs through B14 (``ops.ssd_scan``, which refuses to be
    differentiated through on the card) unless ``plain`` is set, as the
    training ``decoder.forward`` sets it: that takes the differentiable
    :func:`ssd_chunk_scan_plain`, as do meta inputs (the dry-run's shapes,
    where the chunked scan is the reference's prefill computation and B14's
    plain version, the token-sequential recurrence, would be one Python
    step per token). Returns (out (B, S, d_model), (conv cache, final
    state))."""
    if state is not None:
        raise NotImplementedError(
            "ssm_mixer: prefill starts from a zero state; a carried "
            "initial state has no caller in the port")
    bsz, s, _ = x.shape
    d_inner, _, _ = proj_dims(cfg)
    n = cfg.ssm_state
    z, xin, b, c, dt = _split_proj(cfg, x @ lp["in_proj"])
    conv_out, conv_cache = _causal_conv(cfg, lp, torch.cat([xin, b, c], -1))
    xin, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + lp["dt_bias"])                    # (B,S,H)
    a = dt * -torch.exp(lp["A_log"])                               # log decay
    xh = xin.reshape(bsz, s, cfg.ssm_heads, cfg.ssm_head_dim)
    args = (xh, dt, a, b.float(), c.float())
    scan = ssd_chunk_scan_plain if plain or x.is_meta else _ssd_chunk_scan
    y, new_state = scan(cfg, *args)
    return _gated_out(cfg, lp, y, z, xh, x.dtype), (conv_cache, new_state)


def ssm_decode_step(cfg, lp, x, conv_cache, state):
    """One-token recurrent update. x (B, 1, d_model); conv_cache
    (B, W-1, conv_dim); state (B, H, P, N) float32. Returns (out, (new conv
    cache, new state))."""
    bsz = x.shape[0]
    d_inner, _, _ = proj_dims(cfg)
    n = cfg.ssm_state
    z, xin, b, c, dt = _split_proj(cfg, x @ lp["in_proj"])
    conv_out, conv_cache = _causal_conv(cfg, lp, torch.cat([xin, b, c], -1),
                                        conv_cache)
    xin, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt[:, 0].float() + lp["dt_bias"])              # (B, H)
    da = torch.exp(dt * -torch.exp(lp["A_log"]))
    xh = xin[:, 0].reshape(bsz, cfg.ssm_heads, cfg.ssm_head_dim).float()
    bf, cf = b[:, 0].float(), c[:, 0].float()
    new_state = state * da[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, bf)
    y = torch.einsum("bhpn,bn->bhp", new_state, cf)[:, None]
    return (_gated_out(cfg, lp, y, z, xh[:, None], x.dtype),
            (conv_cache, new_state))
