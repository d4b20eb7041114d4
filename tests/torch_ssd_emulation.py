"""The SSD scan's tensor-core route (``csrc/ssd_scan.cu``, ``ssd_scan_tc``)
emulated in plain torch, on whatever device its inputs are on: the CPU
tests hold it to the Pallas kernel, and ``tools/ssd_breakdown.py`` runs it
on the card beside the kernel at the same inputs. Imports neither JAX nor
the JAX package.

A float32 operand of a product is split into ``parts`` bf16 parts (each
the bf16 rounding of what the parts before it leave; the kernel takes
three), a bf16 x is one exact part, and a product sums the part products
with i + j < parts, smallest first, in float32 (the MMAs' own summation
order is not emulated). ``parts=None`` splits nothing and runs in float64:
the same chunked algebra without rounding, a reference for each term. The
decay exponents are the kernel's sums of one sign, in its order: D, the
segment sums inside each 16-token block (a column scan down the block),
the block starts' prefixes R, the block ends' suffixes S and the block
totals T, combined as the head comment of csrc/ssd_scan.cu sets out;
exp(pre_i) scales c before its split.
"""
import numpy as np
import torch


def ssd_inputs(rng, b, s, h, p, n, a_scale=None):
    """numpy x (B, S, H, P), dt and a = dt A (B, S, H) float32, b and c
    (B, S, N), drawn as the JAX package's test_ssd_scan draws them; with
    a_scale, A = -(1 .. a_scale) over the heads."""
    x = rng.standard_normal((b, s, h, p))
    dtv = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    big_a = (-np.exp(0.5 * rng.standard_normal(h)) if a_scale is None
             else -np.linspace(1.0, a_scale, h))
    av = (dtv * big_a.astype(np.float32)).astype(np.float32)
    return (x, dtv, av, rng.standard_normal((b, s, n)),
            rng.standard_normal((b, s, n)))


def split(t, parts):
    """``parts`` bf16 parts of ``t`` as float32, largest first."""
    out, r = [], t.float()
    for _ in range(parts):
        hi = r.to(torch.bfloat16).float()
        out.append(hi)
        r = r - hi
    return out


def _mm_split(a, b, parts):
    if parts is None:
        return a.double() @ b.double()
    ap = [a.float()] if a.dtype == torch.bfloat16 else split(a, parts)
    bp = [b.float()] if b.dtype == torch.bfloat16 else split(b, parts)
    out = 0.0
    for total in range(parts - 1, -1, -1):
        for i, ai in enumerate(ap):
            if 0 <= total - i < len(bp):
                out = out + ai @ bp[total - i]
    return out


def _chunked(x, dt, a, b, c, q, wd=torch.float32):
    """(B, C, H, Q, P) x, (B, C, H, Q) dt and a, (B, C, Q, N) b and c, all
    but x in ``wd``."""
    bsz, s, h, p = x.shape
    nc = s // q
    return (x.reshape(bsz, nc, q, h, p).permute(0, 1, 3, 2, 4),
            *(t.to(wd).reshape(bsz, nc, q, h).permute(0, 1, 3, 2)
              for t in (dt, a)),
            *(t.to(wd).reshape(bsz, nc, q, -1) for t in (b, c)))


def _state_pass(cs, decay):
    """States entering each chunk (B, C, H, P, N) and the final state."""
    st, entering = torch.zeros_like(cs[:, 0]), []
    for ck in range(cs.shape[1]):
        entering.append(st)
        st = st * decay[:, ck, :, None, None] + cs[:, ck]
    return torch.stack(entering, 1), st


def _unchunk(y):
    bsz, nc, h, q, p = y.shape
    return y.permute(0, 1, 3, 2, 4).reshape(bsz, nc * q, h, p)


def _decay_sums(ac, blk=16):
    """The kernel's exponents over the last axis of ac (Q a multiple of
    the 16-token block): seg (..., Q, Q) on and below the diagonal (0
    above), pre (..., Q), the suffixes of dec (..., Q) and the chunk
    totals (...)."""
    q = ac.shape[-1]
    nb = q // blk
    idx = torch.arange(q, device=ac.device)
    d = ac.new_zeros(ac.shape + (q,))        # D[..., i, j], same block
    for j in range(q):
        s = torch.zeros_like(ac[..., 0])
        for i in range(j + 1, (j // blk + 1) * blk):
            s = s + ac[..., i]
            d[..., i, j] = s
    first = idx // blk * blk
    r = ac[..., first] + d[..., idx, first]              # R_i
    sfx = d[..., idx // blk * blk + blk - 1, idx]        # S_j
    t = [r[..., k * blk + blk - 1] for k in range(nb)]   # T_K

    def tsum(lo, hi):           # T_lo + ... + T_{hi-1}, ascending
        out = torch.zeros_like(t[0])
        for k in range(lo, hi):
            out = out + t[k]
        return out

    seg = torch.zeros_like(d)
    pre, tail = torch.zeros_like(ac), torch.zeros_like(ac)
    for i in range(q):
        bi = i // blk
        pre[..., i] = tsum(0, bi) + r[..., i]
        tail[..., i] = sfx[..., i] + tsum(bi + 1, nb)
        for j in range(i + 1):
            bj = j // blk
            seg[..., i, j] = d[..., i, j] if bi == bj else \
                (r[..., i] + tsum(bj + 1, bi)) + sfx[..., j]
    total = tsum(0, 1)
    for k in range(1, nb):
        total = total + t[k]
    return seg, pre, tail, total


def emulate_ssd_terms(x, dt, a, b, c, chunk=64, parts=3):
    """y's two terms as the kernel's y launch sums them, (G o L) x (intra)
    and (exp(pre) c) state_in^T (inter), each (B, S, H, P), and the final
    state."""
    wd = torch.float64 if parts is None else torch.float32
    xc, dtc, ac, bc, cc = _chunked(x, dt, a, b, c, chunk, wd)
    if parts is None:
        xc = xc.double()
    seg, pre, tail, total = _decay_sums(ac)
    gram = _mm_split(cc, bc.transpose(-1, -2), parts)     # (B, C, Q, Q)
    decb = bc[:, :, None] * (dtc * torch.exp(tail))[..., None]
    cs = _mm_split(xc.transpose(-1, -2), decb, parts)     # (B, C, H, P, N)
    entering, state = _state_pass(cs, torch.exp(total))
    col = torch.arange(chunk, device=x.device)
    low = col[:, None] >= col[None, :]
    lmat = torch.where(low, dtc[..., None, :] * torch.exp(seg), 0.0)
    w = torch.where(low, gram[:, :, None] * lmat, 0.0)
    inter = _mm_split(cc[:, :, None] * torch.exp(pre)[..., None],
                      entering.transpose(-1, -2), parts)
    return _unchunk(_mm_split(w, xc, parts)), _unchunk(inter), state


def emulate_ssd_tc(x, dt, a, b, c, chunk=64, parts=3):
    """(y (B, S, H, P), final state (B, H, P, N)) as the kernel computes
    them, with ``parts`` bf16 parts per float32 operand."""
    intra, inter, state = emulate_ssd_terms(x, dt, a, b, c, chunk, parts)
    return inter + intra, state


def emulate_ssd_cumsum_f32(x, dt, a, b, c, chunk=64):
    """The chunked scan in float32 products with the decay exponents as
    differences of the in-chunk cumsum, as the Pallas kernel and the scalar
    route take them."""
    xc, dtc, ac, bc, cc = _chunked(x, dt, a, b, c, chunk)
    xc = xc.float()
    acum = torch.cumsum(ac, -1)
    col = torch.arange(chunk, device=x.device)
    low = col[:, None] >= col[None, :]
    diff = torch.where(low, acum[..., :, None] - acum[..., None, :], 0.0)
    w = (cc @ bc.transpose(-1, -2))[:, :, None] \
        * torch.where(low, torch.exp(diff), 0.0) * dtc[..., None, :]
    dec = dtc * torch.exp(acum[..., -1:] - acum)
    cs = (xc * dec[..., None]).transpose(-1, -2) @ bc[:, :, None]
    entering, state = _state_pass(cs, torch.exp(acum[..., -1]))
    inter = torch.exp(acum)[..., None] \
        * (cc[:, :, None] @ entering.transpose(-1, -2))
    return _unchunk(inter + w @ xc), state
