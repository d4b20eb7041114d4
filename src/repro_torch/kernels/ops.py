"""Public wrappers for the port's kernels, under the names and argument
orders of the JAX package's ``repro.kernels.ops``: the serving path, the
int8 host tier, attention over int8 pools, the single-layer block
copies, the Mamba2 SSD scan and sliding-window prefill attention.

Each wrapper dispatches on the device of its tensors. On the CPU it runs
the plain PyTorch version from ``ref``; on a CUDA tensor it checks device,
dtype (float32 or bfloat16 pools and queries; int8 payloads and pages with
float32 scales; float32 SSD scan parameters), shape and contiguity,
allocates any output and scratch with ``torch.empty``, launches its
hand-written kernel from ``csrc/`` on the current stream, and raises if
the launch is refused. It never falls back to the plain version on the
card. No kernel has a backward: with grad mode on, a CUDA input that
requires grad raises (the outputs would carry no autograd history).

The write wrappers (``kv_token_write``, ``kv_chunk_write``,
``block_scatter``, ``block_scatter_layers``,
``block_scatter_dequant_layers``) update the pools **in place** and
return them. ``rope_kv_token_write`` and ``rope_kv_chunk_write`` (the
decode and prefill layers' RoPE of q and k fused into those two writes,
one launch per layer) also write the pools in place, and return the
roped q.

``launches[name]`` counts the kernel launches of each wrapper on the
card (CPU calls are not counted); ``route_launches`` counts them by route
for a wrapper whose C entries pick a kernel by shape (``ssd_scan:tc``,
``ssd_scan:scalar``); ``reset_launches`` sets every count to 0. A launch
recorded into a CUDA graph runs only when the graph is
replayed, so it is not counted while the graph is captured: the capture
runs inside ``capture_launches()``, which collects its counts, and each
replay adds them (``add_launches``). The caller runs the captured code
once eagerly before the capture, which loads the kernel libraries and
fills the wrappers' caches (the RoPE table, the split counts); a cache
that would be filled during a capture raises instead.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as R

KERNELS = ("kv_token_write", "paged_attention", "kv_chunk_write",
           "paged_prefill_attention", "rope_kv_token_write",
           "rope_kv_chunk_write", "block_gather_layers",
           "block_scatter_layers", "block_gather_quant_layers",
           "block_scatter_dequant_layers", "kv_block_quant",
           "kv_block_dequant", "paged_attention_quant",
           "paged_prefill_attention_quant", "block_gather", "block_scatter",
           "ssd_scan", "swa_attention")
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
ROUTES = ("ssd_scan:tc", "ssd_scan:scalar")
route_launches: Dict[str, int] = dict.fromkeys(ROUTES, 0)

# queries per thread block of the float32 and int8-page prefill kernels
PREFILL_Q_TILE = 4
# threads per block and vectors per thread of the single-layer block
# copies (``_copy_split``; csrc/block_copy.cu)
COPY_THREADS, COPY_VECS = 128, 2
# largest head dim of the fused RoPE + KV write kernels (a block's shared
# cos / sin table holds D floats)
ROPE_MAX_HEAD_DIM = 1024

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float
_SIGNATURES = {
    "kv_token_write": ("kv_write", [_P, _P, _P, _P, _P, _I64, _I64, _I, _I,
                                    _I, _P]),
    "kv_chunk_write": ("kv_write", [_P, _P, _P, _P, _P, _P, _P, _I64, _I,
                                    _I, _I, _I64, _I, _I, _I, _P]),
    "rope_kv_token_write": ("kv_write", [_P] * 9 + [_I64, _I64, _I, _I, _I,
                                                    _I, _P]),
    "rope_kv_chunk_write": ("kv_write", [_P] * 11 + [_I64, _I, _I, _I, _I64,
                                                     _I, _I, _I, _I, _P]),
    "block_gather_layers": ("block_copy", [_P, _P, _P, _I64, _I64, _I64,
                                           _I64, _P]),
    "block_scatter_layers": ("block_copy", [_P, _P, _P, _I64, _I64, _I64,
                                            _I64, _P]),
    "paged_attention": ("paged_attention", [_P, _P, _P, _P, _P, _P, _I64,
                                            _I, _I, _I, _I, _I, _F, _I,
                                            _P]),
    "paged_attention_tc": ("paged_attention", [_P, _P, _P, _P, _P, _P, _P,
                                               _I64, _I, _I, _I, _I, _I, _I,
                                               _F, _P]),
    "paged_decode_splits": ("paged_attention", [_I64, _I, _I, _I, _I, _I]),
    "paged_prefill_attention": ("paged_prefill",
                                [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _I, _P]),
    "block_gather_quant_layers": ("block_quant", [_P, _P, _P, _P, _I64,
                                                  _I64, _I64, _I, _I, _I,
                                                  _I, _P]),
    "block_scatter_dequant_layers": ("block_quant", [_P, _P, _P, _P, _I64,
                                                     _I64, _I64, _I, _I, _I,
                                                     _I, _P]),
    "kv_block_quant": ("block_quant", [_P, _P, _P, _I64, _I, _I, _I, _I,
                                       _P]),
    "kv_block_dequant": ("block_quant", [_P, _P, _P, _I64, _I, _I, _I, _I,
                                         _P]),
    "paged_attention_quant": ("paged_attention",
                              [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I,
                               _I, _I, _I, _F, _I, _P]),
    "paged_attention_quant_tc": ("paged_attention",
                                 [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                  _I, _I, _I, _I, _I, _I, _F, _P]),
    "paged_prefill_attention_quant": ("paged_prefill",
                                      [_P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                       _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                       _P]),
    "block_gather": ("block_copy", [_P, _P, _P, _I64, _I64, _I64, _I, _I64,
                                    _I64, _P]),
    "block_scatter": ("block_copy", [_P, _P, _P, _I64, _I64, _I64, _I, _I64,
                                     _I64, _P]),
    "ssd_scan": ("ssd_scan", [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                              _I, _I, _I, _I, _I, _P]),
    "ssd_scan_tc": ("ssd_scan", [_P] * 10 + [_I64] + [_I] * 6 + [_P]),
    "swa_attention": ("swa_attention", [_P, _P, _P, _P, _I64, _I, _I, _I,
                                        _I, _F, _I, _P]),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}
# the launch counts of the CUDA graph being captured (capture_launches)
_captured: Optional[Dict[str, int]] = None


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def capture_launches():
    """Collect the launches made while a CUDA graph is captured, in a dict
    {name: count} that the context yields (every launch under capture
    must happen inside this context; replays add it with
    ``add_launches``)."""
    global _captured
    if _captured is not None:
        raise RuntimeError("capture_launches: a capture is already being "
                           "counted")
    _captured = dict.fromkeys(KERNELS + ROUTES, 0)
    try:
        yield _captured
    finally:
        _captured = None


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture launched
    ``counts``."""
    for k, n in counts.items():
        if n:
            (launches if k in launches else route_launches)[k] += n * times


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib_name, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(lib_name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args, entry: str = None,
            route: str = None) -> None:
    """Launch C entry ``entry`` (default: ``name``) on the current stream
    and count one launch of ``name`` (and of ``name:route`` when a route
    is given)."""
    if device.index is not None and \
            device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {device}, but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    rc = _fn(entry or name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    keys = (name,) if route is None else (name, f"{name}:{route}")
    if not torch.cuda.is_current_stream_capturing():
        for k in keys:
            (launches if k in launches else route_launches)[k] += 1
    elif _captured is None:
        raise RuntimeError(f"{name}: launched into a CUDA graph outside "
                           "ops.capture_launches(), so its replays would "
                           "go uncounted")
    else:
        for k in keys:
            _captured[k] += 1


def _on_cpu(name: str, *tensors) -> bool:
    """True when every tensor is on the CPU, or every tensor is on the meta
    device (shapes only, as in the dry-run: nothing is computed there and
    nothing can be launched), so the caller takes the plain version;
    raises unless they all share one CUDA device otherwise. The kernels
    fill their outputs through raw pointers, so those carry no autograd
    history: a CUDA input that needs a gradient raises rather than lose it
    silently."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")} or devs == {torch.device("meta")}:
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or len(devs) != 1:
        raise ValueError(f"{name}: tensors must all be on the CPU, all on "
                         f"the meta device or all on one CUDA device, got "
                         f"{sorted(map(str, devs))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and an "
                           "input requires grad; differentiate through the "
                           "plain version (the training forward does) or "
                           "call it under torch.no_grad()")
    return False


def _check(name: str, what: str, t: torch.Tensor, ndim: int,
           dtype=None) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


def _check_pools(name: str, k_pages, v_pages) -> int:
    if k_pages.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: pools must be float32 or bfloat16, got "
                        f"{k_pages.dtype}")
    _check(name, "k_pages", k_pages, 4)
    _check(name, "v_pages", v_pages, 4, k_pages.dtype)
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: k/v pool shapes differ")
    return _DTYPE_CODE[k_pages.dtype]


def _require(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


# ---------------------------------------------------------------------------
# decode: B1 kv_token_write (alone, and fused with the RoPE of q and k),
# B2 paged_attention
# ---------------------------------------------------------------------------

def kv_token_write(k_pages, v_pages, k_new, v_new, slots):
    """Write one token's K/V per sequence into the pools, in place.

    k_pages/v_pages: (N, bs, Hkv, D); k_new/v_new: (B, Hkv, D) of the pool
    dtype; slots: (B,) int32 absolute slot ids (block * bs + offset); slots
    outside the pool are not written. Returns (k_pages, v_pages).
    """
    name = "kv_token_write"
    if _on_cpu(name, k_pages, v_pages, k_new, v_new, slots):
        return R.kv_token_write_ref(k_pages, v_pages, k_new, v_new, slots)
    code, n, bs, hkv, d = _check_token_write(name, k_pages, v_pages, k_new,
                                             v_new, slots)
    b = k_new.shape[0]
    if b:
        _launch(name, k_pages.device, k_pages.data_ptr(),
                v_pages.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                slots.data_ptr(), b, n * bs, hkv, d, code)
    return k_pages, v_pages


def rope_kv_token_write(q, k, v, k_pages, v_pages, slots, positions, theta):
    """The decode layer's RoPE and KV write in one launch: split-half RoPE
    of q and k at ``positions`` in float32, rounded to the pool dtype, then
    the roped k and v written at ``slots`` as :func:`kv_token_write` does
    (pools updated in place).

    q: (B, H, D); k/v: (B, Hkv, D), all of the pool dtype; pools
    (N, bs, Hkv, D); slots, positions: (B,) int32; theta: the RoPE base.
    D must be even. Returns the roped q, a new (B, H, D) tensor."""
    name = "rope_kv_token_write"
    if _on_cpu(name, q, k, v, k_pages, v_pages, slots, positions):
        return R.rope_kv_token_write_ref(q, k, v, k_pages, v_pages, slots,
                                         positions, theta)
    code, n, bs, hkv, d = _check_token_write(name, k_pages, v_pages, k, v,
                                             slots)
    _check(name, "q", q, 3, k_pages.dtype)
    _check(name, "positions", positions, 1, torch.int32)
    b, h = q.shape[:2]
    _require(name, q.shape == (b, h, d) and k.shape[0] == b
             and positions.shape == (b,), "shape mismatch")
    freqs = _rope_freqs(name, d, theta, q.device)
    out = torch.empty_like(q)
    if b:
        _launch(name, q.device, q.data_ptr(), out.data_ptr(), k.data_ptr(),
                v.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                slots.data_ptr(), positions.data_ptr(), freqs.data_ptr(), b,
                n * bs, h, hkv, d, code)
    return out


def _check_token_write(name, k_pages, v_pages, k_new, v_new, slots):
    """Pools, new K/V and slots of a decode write; returns (dtype code, N,
    bs, Hkv, D)."""
    code = _check_pools(name, k_pages, v_pages)
    n, bs, hkv, d = k_pages.shape
    _check(name, "k_new", k_new, 3, k_pages.dtype)
    _check(name, "v_new", v_new, 3, k_pages.dtype)
    _check(name, "slots", slots, 1, torch.int32)
    b = k_new.shape[0]
    _require(name, k_new.shape == (b, hkv, d) and v_new.shape == k_new.shape
             and slots.shape == (b,), "shape mismatch")
    return code, n, bs, hkv, d


_freqs: Dict[tuple, torch.Tensor] = {}


def rope_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The (D/2,) float32 RoPE frequencies on ``device``, computed once by
    the plain version's torch expression, so the fused kernels and the
    plain version on the card read identical frequencies. Made during a
    CUDA graph capture, the table would live in the graph's private
    memory, so a miss there raises (an eager call fills it first)."""
    key = (d, theta, device)
    t = _freqs.get(key)
    if t is None:
        if _capturing():
            raise RuntimeError(f"rope_freqs{key}: not made before the CUDA "
                               "graph capture (run the step once eagerly "
                               "first)")
        t = _freqs[key] = R.rope_frequencies(d, theta, device)
    return t


def _rope_freqs(name, d, theta, device):
    _require(name, d % 2 == 0 and d <= ROPE_MAX_HEAD_DIM,
             f"needs an even D <= {ROPE_MAX_HEAD_DIM}, got {d}")
    return rope_freqs(d, float(theta), device)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens):
    """Decode attention: q (B, H, D) over pools (N, bs, Hkv, D) through
    block_tables (B, P) int32, attending to positions < context_lens (B,)
    int32. Rows with context_lens = 0 give zeros. Returns (B, H, D).

    bf16 q with D a multiple of 16 up to 128, over pools that start on a
    16-byte boundary, takes the split-context tensor-core kernel: the
    wrapper asks for the split count (``decode_splits``, from the shapes
    alone) and allocates the float32 scratch of the splits' partials; the
    C entry launches the split kernel and the combine. float32, and bf16
    with other head dims, take the first, scalar kernel (D <= 256). Each
    shape has one kernel; one call counts one launch."""
    name = "paged_attention"
    if _on_cpu(name, q, k_pages, v_pages, block_tables, context_lens):
        return R.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                     context_lens)
    code = _check_pools(name, k_pages, v_pages)
    _check(name, "q", q, 3, k_pages.dtype)
    b, bs, hkv, g, d = _check_decode(name, q, k_pages, block_tables,
                                     context_lens)
    out = torch.empty_like(q)
    if b and _decode_tc(q, k_pages, v_pages):
        _launch_decode_tc(name, q, (k_pages, v_pages), (), block_tables,
                          context_lens, out, bs, hkv, g)
    elif b:
        _launch(name, q.device, q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                context_lens.data_ptr(), out.data_ptr(), b,
                block_tables.shape[1], bs, hkv, g, d, 1.0 / math.sqrt(d),
                code)
    return out


def _decode_tc(q, k_pages, v_pages) -> bool:
    """Whether a decode call takes the split-context tensor-core kernel:
    bf16 q with D a multiple of 16 up to 128, pools on a 16-byte boundary
    (16-byte asynchronous copies) and q on a 4-byte one. The C entries
    hold the same rule (``dc_takes``) and refuse a call on the other
    route."""
    d = q.shape[-1]
    return (q.dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
            and k_pages.data_ptr() % 16 == 0
            and v_pages.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0)


@functools.lru_cache(maxsize=None)
def decode_splits(device: int, b: int, p: int, bs: int, hkv: int, d: int,
                  quant: bool) -> int:
    """Runs per (sequence, kv head) context of the split-context decode
    kernel on CUDA device ``device`` for B sequences over (B, P) tables of
    bs-token pages: about one wave of its blocks, from the shapes and the
    kernel's occupancy alone (``paged_decode_splits`` in
    ``csrc/paged_attention.cu``), never from context_lens. Cached per
    shape; a miss during a CUDA graph capture raises (an eager call of
    the same shapes fills it first)."""
    if _capturing():
        raise RuntimeError(f"decode_splits: shapes (B {b}, P {p}) first "
                           "seen during a CUDA graph capture (run the "
                           "step once eagerly first)")
    with torch.cuda.device(device):
        n = _fn("paged_decode_splits")(b, p, bs, hkv, d, int(quant))
    if n < 1:
        raise RuntimeError(f"paged_decode_splits failed with cudaError {-n}")
    return n


def _launch_decode_tc(name, q, pages, scales, tables, lens, out, bs, hkv,
                      g):
    """One launch of the split-context decode entry ``name``_tc: the split
    count, the float32 scratch of the partials (O, then (m, l)) in one
    tensor, and the call."""
    b, p = tables.shape
    d = q.shape[-1]
    dev = torch.cuda.current_device()
    splits = decode_splits(dev, b, p, bs, hkv, d, bool(scales))
    scratch = torch.empty(b * hkv * g * splits * (d + 2),
                          dtype=torch.float32, device=q.device)
    _launch(name, q.device, q.data_ptr(),
            *(t.data_ptr() for t in (*pages, *scales)), tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, p, bs,
            hkv, g, d, splits, 1.0 / math.sqrt(d), entry=f"{name}_tc")


def _check_decode(name, q, pages, block_tables, context_lens):
    """Shapes of a decode attention call; returns (B, bs, Hkv, G, D)."""
    _, bs, hkv, d = pages.shape
    _check(name, "block_tables", block_tables, 2, torch.int32)
    _check(name, "context_lens", context_lens, 1, torch.int32)
    b, h, _ = q.shape
    _require(name, q.shape[2] == d and h % hkv == 0
             and block_tables.shape[0] == b and context_lens.shape == (b,),
             "shape mismatch")
    g = h // hkv
    _require(name, g <= 16 and d <= 256 and bs <= 256,
             "needs H/Hkv <= 16, D <= 256 and bs <= 256")
    return b, bs, hkv, g, d


# ---------------------------------------------------------------------------
# prefill: B3 kv_chunk_write (alone, and fused with the RoPE of q and k),
# B4 paged_prefill_attention
# ---------------------------------------------------------------------------

def kv_chunk_write(k_pages, v_pages, k_new, v_new, wpages, wstart, wcount):
    """Write one suffix chunk per sequence into the pools, in place.

    k_pages/v_pages: (N, bs, Hkv, D); k_new/v_new: (B, C, Hkv, D) of the
    pool dtype; wpages: (B, PP) int32 destination pages of each row's write
    window in order; wstart: (B,) int32 in-page offset of the first token;
    wcount: (B,) int32 valid tokens per row (later tokens are not written;
    nor are tokens whose page lies outside the window or the pool).
    Returns (k_pages, v_pages).
    """
    name = "kv_chunk_write"
    if _on_cpu(name, k_pages, v_pages, k_new, v_new, wpages, wstart, wcount):
        return R.kv_chunk_write_ref(k_pages, v_pages, k_new, v_new, wpages,
                                    wstart, wcount)
    code, n, bs, hkv, d = _check_chunk_write(name, k_pages, v_pages, k_new,
                                             v_new, wpages, wstart, wcount)
    b, c = k_new.shape[:2]
    if b and c:
        _launch(name, k_pages.device, k_pages.data_ptr(),
                v_pages.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                wpages.data_ptr(), wstart.data_ptr(), wcount.data_ptr(), b, c,
                wpages.shape[1], bs, n * bs, hkv, d, code)
    return k_pages, v_pages


def rope_kv_chunk_write(q, k, v, k_pages, v_pages, wpages, wstart, wcount,
                        positions, theta):
    """The prefill layer's RoPE and KV write in one launch: split-half RoPE
    of every token of q and k at ``positions`` in float32, rounded to the
    pool dtype, then the roped k and v written through the row windows as
    :func:`kv_chunk_write` does (pools updated in place).

    q: (B, C, H, D); k/v: (B, C, Hkv, D), all of the pool dtype; pools,
    wpages, wstart, wcount as in :func:`kv_chunk_write`; positions: (B, C)
    int32 (padded queries at a clamped position, >= 0); theta: the RoPE
    base. D must be even. Returns the roped q, a new (B, C, H, D) tensor:
    every token, padded ones included."""
    name = "rope_kv_chunk_write"
    if _on_cpu(name, q, k, v, k_pages, v_pages, wpages, wstart, wcount,
               positions):
        return R.rope_kv_chunk_write_ref(q, k, v, k_pages, v_pages, wpages,
                                         wstart, wcount, positions, theta)
    code, n, bs, hkv, d = _check_chunk_write(name, k_pages, v_pages, k, v,
                                             wpages, wstart, wcount)
    _check(name, "q", q, 4, k_pages.dtype)
    _check(name, "positions", positions, 2, torch.int32)
    b, c, h = q.shape[:3]
    _require(name, q.shape == (b, c, h, d) and k.shape[:2] == (b, c)
             and positions.shape == (b, c), "shape mismatch")
    freqs = _rope_freqs(name, d, theta, q.device)
    out = torch.empty_like(q)
    if b and c:
        _launch(name, q.device, q.data_ptr(), out.data_ptr(), k.data_ptr(),
                v.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                wpages.data_ptr(), wstart.data_ptr(), wcount.data_ptr(),
                positions.data_ptr(), freqs.data_ptr(), b, c,
                wpages.shape[1], bs, n * bs, h, hkv, d, code)
    return out


def _check_chunk_write(name, k_pages, v_pages, k_new, v_new, wpages, wstart,
                       wcount):
    """Pools, new K/V and windows of a chunk write; returns (dtype code, N,
    bs, Hkv, D)."""
    code = _check_pools(name, k_pages, v_pages)
    n, bs, hkv, d = k_pages.shape
    _check(name, "k_new", k_new, 4, k_pages.dtype)
    _check(name, "v_new", v_new, 4, k_pages.dtype)
    _check(name, "wpages", wpages, 2, torch.int32)
    _check(name, "wstart", wstart, 1, torch.int32)
    _check(name, "wcount", wcount, 1, torch.int32)
    b, c = k_new.shape[:2]
    _require(name, k_new.shape == (b, c, hkv, d)
             and v_new.shape == k_new.shape and wpages.shape[0] == b
             and wstart.shape == (b,) and wcount.shape == (b,),
             "shape mismatch")
    return code, n, bs, hkv, d


def paged_prefill_attention(q, k_pages, v_pages, block_tables, q_pos):
    """Chunked suffix-prefill attention: q (B, C, H, D) at absolute
    positions q_pos (B, C) int32 attends to pool positions <= q_pos
    through block_tables (B, P) int32; q_pos = -1 rows give zeros.
    Returns (B, C, H, D).

    bf16 pools go to a tensor-core kernel (mma.sync on 16 x 16 bf16
    tiles, with D a template parameter), which takes D a multiple of 16 up
    to 128 and pools whose data starts on a 16-byte boundary (16-byte
    asynchronous copies); other bf16 calls raise. float32 pools take D
    and bs multiples of 4."""
    name = "paged_prefill_attention"
    if _on_cpu(name, q, k_pages, v_pages, block_tables, q_pos):
        return R.paged_prefill_attention_ref(q, k_pages, v_pages,
                                             block_tables, q_pos)
    code = _check_pools(name, k_pages, v_pages)
    _check(name, "q", q, 4, k_pages.dtype)
    b, c, bs, hkv, g, d = _check_prefill(name, q, k_pages, block_tables,
                                         q_pos)
    if k_pages.dtype == torch.bfloat16:
        _require(name, d % 16 == 0 and d <= 128,
                 f"bf16 pools need D a multiple of 16 up to 128 (the "
                 f"tensor-core kernel's head dims), got {d}")
        _require(name, k_pages.data_ptr() % 16 == 0
                 and v_pages.data_ptr() % 16 == 0,
                 "bf16 pools must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if b and c:
        _launch(name, q.device, q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                q_pos.data_ptr(), out.data_ptr(), b, c,
                block_tables.shape[1], bs, hkv, g, d, PREFILL_Q_TILE,
                1.0 / math.sqrt(d), code)
    return out


def _check_prefill(name, q, pages, block_tables, q_pos):
    """Shapes of a prefill attention call; returns (B, C, bs, Hkv, G, D)."""
    _, bs, hkv, d = pages.shape
    _check(name, "block_tables", block_tables, 2, torch.int32)
    _check(name, "q_pos", q_pos, 2, torch.int32)
    b, c, h, _ = q.shape
    _require(name, q.shape[3] == d and h % hkv == 0
             and block_tables.shape[0] == b and q_pos.shape == (b, c),
             "shape mismatch")
    _require(name, h // hkv <= 16 and d % 4 == 0 and bs % 4 == 0,
             "needs H/Hkv <= 16 and D, bs multiples of 4")
    return b, c, bs, hkv, h // hkv, d


# ---------------------------------------------------------------------------
# migration: B5 block_gather_layers, B6 block_scatter_layers, and one
# layer's pool: B13a block_gather, B13b block_scatter
# ---------------------------------------------------------------------------

def _check_layers(name, pools, indices):
    if pools.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: pools must be float32 or bfloat16, got "
                        f"{pools.dtype}")
    _check(name, "pools", pools, 5)
    _check(name, "indices", indices, 1, torch.int32)
    nl, n = pools.shape[:2]
    run = pools[0, 0].numel() * pools.element_size()
    return nl, n, indices.shape[0], run


def block_gather_layers(pools, indices):
    """Gather blocks ``indices`` (M,) int32 of every layer of pools
    (L, N, bs, Hkv, D) into a new staging tensor (L, M, bs, Hkv, D)."""
    name = "block_gather_layers"
    if _on_cpu(name, pools, indices):
        return R.block_gather_layers_ref(pools, indices)
    nl, n, m, run = _check_layers(name, pools, indices)
    out = torch.empty((nl, m) + tuple(pools.shape[2:]), dtype=pools.dtype,
                      device=pools.device)
    if m:
        _launch(name, pools.device, pools.data_ptr(), out.data_ptr(),
                indices.data_ptr(), nl, n, m, run)
    return out


def block_scatter_layers(pools, indices, staging):
    """Scatter staging (L, M, bs, Hkv, D) into blocks ``indices`` (M,)
    int32 of every layer of pools (L, N, bs, Hkv, D), in place. Returns
    ``pools``."""
    name = "block_scatter_layers"
    if _on_cpu(name, pools, indices, staging):
        return R.block_scatter_layers_ref(pools, indices, staging)
    nl, n, m, run = _check_layers(name, pools, indices)
    _check(name, "staging", staging, 5, pools.dtype)
    _require(name, staging.shape == (nl, m) + tuple(pools.shape[2:]),
             "staging shape mismatch")
    if m:
        _launch(name, pools.device, pools.data_ptr(), staging.data_ptr(),
                indices.data_ptr(), nl, n, m, run)
    return pools


def _copy_vec(run_bytes: int, *ptrs: int) -> int:
    """The widest vector (16, 4 or 2 bytes) of a copy of runs of
    ``run_bytes`` between bases ``ptrs``: every base and the run length
    must be multiples of it."""
    bits = run_bytes
    for p in ptrs:
        bits |= p
    return 16 if bits % 16 == 0 else 4 if bits % 4 == 0 else 2


def _copy_split(m: int, run_bytes: int, vec: int):
    """The single-layer copies' split of each of ``m`` runs of
    ``run_bytes`` into chunks, one CUDA thread block per (block, chunk) of
    an (m, chunks) grid: (chunk bytes, chunks per run). A chunk is what one
    block copies in one pass, ``COPY_THREADS * COPY_VECS`` vectors of
    ``vec`` bytes (4 KiB of 16-byte vectors: 8 chunks of a 32 KiB run, so
    32 blocks give 256 thread blocks, about two per SM), or the whole run
    if that is shorter; the last chunk of a run takes what is left."""
    chunk = min(COPY_THREADS * COPY_VECS * vec, run_bytes)
    n_chunks = -(-run_bytes // chunk)
    if m > 2**31 - 1 or n_chunks > 65535:
        raise ValueError(f"block copy: {m} blocks of {n_chunks} chunks "
                         "exceed a CUDA grid")
    return chunk, n_chunks


def _launch_copy(name, pages, staging, indices, n, m, run):
    vec = _copy_vec(run, pages.data_ptr(), staging.data_ptr())
    _launch(name, pages.device, pages.data_ptr(), staging.data_ptr(),
            indices.data_ptr(), n, m, run, vec, *_copy_split(m, run, vec))


def block_gather(pages, indices):
    """Gather blocks ``indices`` (M,) int32 of one layer's pool
    (N, bs, Hkv, D) into a new staging tensor (M, bs, Hkv, D)."""
    name = "block_gather"
    if _on_cpu(name, pages, indices):
        return R.block_gather_ref(pages, indices)
    _check(name, "pages", pages, 4)
    _, n, m, run = _check_layers(name, pages[None], indices)
    out = torch.empty((m,) + tuple(pages.shape[1:]), dtype=pages.dtype,
                      device=pages.device)
    if m:
        _launch_copy(name, pages, out, indices, n, m, run)
    return out


def block_scatter(pages, indices, staging):
    """Scatter staging (M, bs, Hkv, D) into blocks ``indices`` (M,) int32,
    distinct, of one layer's pool (N, bs, Hkv, D), in place. Returns
    ``pages``."""
    name = "block_scatter"
    if _on_cpu(name, pages, indices, staging):
        return R.block_scatter_ref(pages, indices, staging)
    _check(name, "pages", pages, 4)
    _, n, m, run = _check_layers(name, pages[None], indices)
    _check(name, "staging", staging, 4, pages.dtype)
    _require(name, staging.shape == (m,) + tuple(pages.shape[1:]),
             "staging shape mismatch")
    if m:
        _launch_copy(name, pages, staging, indices, n, m, run)
    return pages


# ---------------------------------------------------------------------------
# int8 host tier: B7 block_gather_quant_layers, B8
# block_scatter_dequant_layers, B11 kv_block_quant, B12 kv_block_dequant
# ---------------------------------------------------------------------------

def _check_quant(name, what, q, scales, shape):
    """An int8 payload ``what`` of ``shape`` and float32 scales of
    ``shape`` without its (bs, D) axes."""
    _check(name, what, q, len(shape), torch.int8)
    _check(name, "scales", scales, len(shape) - 2, torch.float32)
    _require(name, tuple(q.shape) == tuple(shape),
             f"{what} shape {tuple(q.shape)} != {tuple(shape)}")
    want = tuple(shape[:-3]) + (shape[-2],)
    _require(name, tuple(scales.shape) == want,
             f"scales shape {tuple(scales.shape)} != {want}")


def block_gather_quant_layers(pools, indices):
    """Gather blocks ``indices`` (M,) int32 of every layer of pools
    (L, N, bs, Hkv, D) and quantize each (layer, block, kv head) to int8:
    returns (q (L, M, bs, Hkv, D) int8, scales (L, M, Hkv) float32)."""
    name = "block_gather_quant_layers"
    if _on_cpu(name, pools, indices):
        return R.block_gather_quant_layers_ref(pools, indices)
    nl, n, m, _ = _check_layers(name, pools, indices)
    bs, hkv, d = pools.shape[2:]
    q = torch.empty((nl, m, bs, hkv, d), dtype=torch.int8,
                    device=pools.device)
    scales = torch.empty((nl, m, hkv), dtype=torch.float32,
                         device=pools.device)
    if m:
        _launch(name, pools.device, pools.data_ptr(), q.data_ptr(),
                scales.data_ptr(), indices.data_ptr(), nl, n, m, bs, hkv, d,
                _DTYPE_CODE[pools.dtype])
    return q, scales


def block_scatter_dequant_layers(pools, indices, staging, scales):
    """Dequantize staging (L, M, bs, Hkv, D) int8 with scales (L, M, Hkv)
    float32 to the pool dtype and write it into blocks ``indices`` (M,)
    int32 of every layer of pools (L, N, bs, Hkv, D), in place. Returns
    ``pools``."""
    name = "block_scatter_dequant_layers"
    if _on_cpu(name, pools, indices, staging, scales):
        return R.block_scatter_dequant_layers_ref(pools, indices, staging,
                                                  scales)
    nl, n, m, _ = _check_layers(name, pools, indices)
    bs, hkv, d = pools.shape[2:]
    _check_quant(name, "staging", staging, scales, (nl, m, bs, hkv, d))
    if m:
        _launch(name, pools.device, pools.data_ptr(), staging.data_ptr(),
                scales.data_ptr(), indices.data_ptr(), nl, n, m, bs, hkv, d,
                _DTYPE_CODE[pools.dtype])
    return pools


def kv_block_quant(blocks):
    """Quantize staged blocks (M, bs, Hkv, D) float32 or bfloat16 to int8:
    returns (q (M, bs, Hkv, D) int8, scales (M, Hkv) float32)."""
    name = "kv_block_quant"
    if _on_cpu(name, blocks):
        return R.quantize_block_ref(blocks)
    if blocks.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: blocks must be float32 or bfloat16, got "
                        f"{blocks.dtype}")
    _check(name, "blocks", blocks, 4)
    m, bs, hkv, d = blocks.shape
    q = torch.empty(blocks.shape, dtype=torch.int8, device=blocks.device)
    scales = torch.empty((m, hkv), dtype=torch.float32, device=blocks.device)
    if m:
        _launch(name, blocks.device, blocks.data_ptr(), q.data_ptr(),
                scales.data_ptr(), m, bs, hkv, d, _DTYPE_CODE[blocks.dtype])
    return q, scales


def kv_block_dequant(q, scales, out_dtype=torch.float32):
    """Dequantize int8 blocks (M, bs, Hkv, D) with scales (M, Hkv) float32
    to a new (M, bs, Hkv, D) tensor of ``out_dtype`` (float32 or
    bfloat16)."""
    name = "kv_block_dequant"
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if _on_cpu(name, q, scales):
        return R.dequantize_block_ref(q, scales, out_dtype)
    _check(name, "q", q, 4, torch.int8)
    m, bs, hkv, d = q.shape
    _check_quant(name, "q", q, scales, (m, bs, hkv, d))
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if m:
        _launch(name, q.device, q.data_ptr(), scales.data_ptr(),
                out.data_ptr(), m, bs, hkv, d, _DTYPE_CODE[out_dtype])
    return out


# ---------------------------------------------------------------------------
# attention over int8 pools: B9 paged_attention_quant, B10
# paged_prefill_attention_quant
# ---------------------------------------------------------------------------

def _check_int8_pools(name, q, q_ndim, k_pages, v_pages, k_scale, v_scale):
    """float32 / bfloat16 q of ``q_ndim`` dims; int8 pools (N, bs, Hkv, D)
    with float32 scales (N, Hkv). Returns q's dtype code."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    _check(name, "q", q, q_ndim)
    _check(name, "k_pages", k_pages, 4, torch.int8)
    _check(name, "v_pages", v_pages, 4, torch.int8)
    _require(name, k_pages.shape == v_pages.shape, "k/v pool shapes differ")
    want = (k_pages.shape[0], k_pages.shape[2])
    for what, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(name, what, sc, 2, torch.float32)
        _require(name, tuple(sc.shape) == want,
                 f"{what} shape {tuple(sc.shape)} != {want}")
    return _DTYPE_CODE[q.dtype]


def paged_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                          block_tables, context_lens):
    """Decode attention over int8 pools: q (B, H, D) float32 or bfloat16
    over k_pages/v_pages (N, bs, Hkv, D) int8 with scales (N, Hkv) float32,
    dequantized as each page is fetched, through block_tables (B, P) int32
    up to context_lens (B,) int32. Rows with context_lens = 0 give zeros.
    Returns (B, H, D) in q's dtype.

    bfloat16 q with D a multiple of 16 up to 128, over pools that start on
    a 16-byte boundary, takes the int8 instantiation of
    ``paged_attention``'s split-context tensor-core kernel (int8 rows
    converted to bf16 in shared memory, the scales folded into the scores
    and the probabilities in float32), with the float32 scratch of the
    splits' partials allocated here; float32 q, and bfloat16 q with other
    head dims, take the first, scalar kernel. Each shape has one kernel."""
    name = "paged_attention_quant"
    if _on_cpu(name, q, k_pages, v_pages, k_scale, v_scale, block_tables,
               context_lens):
        return R.paged_attention_quant_ref(q, k_pages, v_pages, k_scale,
                                           v_scale, block_tables,
                                           context_lens)
    code = _check_int8_pools(name, q, 3, k_pages, v_pages, k_scale, v_scale)
    b, bs, hkv, g, d = _check_decode(name, q, k_pages, block_tables,
                                     context_lens)
    out = torch.empty_like(q)
    if b and _decode_tc(q, k_pages, v_pages):
        _launch_decode_tc(name, q, (k_pages, v_pages), (k_scale, v_scale),
                          block_tables, context_lens, out, bs, hkv, g)
    elif b:
        _launch(name, q.device, q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), b, block_tables.shape[1], bs, hkv, g, d,
                1.0 / math.sqrt(d), code)
    return out


def paged_prefill_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                  block_tables, q_pos):
    """Chunked suffix-prefill attention over int8 pools: q (B, C, H, D)
    float32 or bfloat16 at positions q_pos (B, C) int32 over k_pages/v_pages
    (N, bs, Hkv, D) int8 with scales (N, Hkv) float32 through block_tables
    (B, P) int32; q_pos = -1 rows give zeros. Returns (B, C, H, D) in q's
    dtype.

    The C entry picks the kernel by shape before the launch: bfloat16 q
    with D a multiple of 16 up to 128, pools starting on a 16-byte
    boundary and q / out on a 4-byte one go to the int8 instantiation of
    the tensor-core kernel of ``paged_prefill_attention`` (int8 rows
    converted to bf16 in shared memory, the scales folded into the scores
    and the probabilities); float32 q, and bfloat16 q of other shapes,
    go to the first, scalar kernel, which takes D and bs multiples of 4.
    Neither is a fallback for the other: each shape has one kernel."""
    name = "paged_prefill_attention_quant"
    if _on_cpu(name, q, k_pages, v_pages, k_scale, v_scale, block_tables,
               q_pos):
        return R.paged_prefill_attention_quant_ref(q, k_pages, v_pages,
                                                   k_scale, v_scale,
                                                   block_tables, q_pos)
    code = _check_int8_pools(name, q, 4, k_pages, v_pages, k_scale, v_scale)
    b, c, bs, hkv, g, d = _check_prefill(name, q, k_pages, block_tables,
                                         q_pos)
    out = torch.empty_like(q)
    if b and c:
        _launch(name, q.device, q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                block_tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(), b,
                c, block_tables.shape[1], bs, hkv, g, d, PREFILL_Q_TILE,
                1.0 / math.sqrt(d), code)
    return out


# ---------------------------------------------------------------------------
# model families: B14 ssd_scan (Mamba2), B15 swa_attention (sliding window)
# ---------------------------------------------------------------------------

# largest SSD chunk and state width, and largest head dim of sliding-window
# attention, that the CUDA kernels take; the chunk and head dim of the SSD
# scan's tensor-core route
SSD_MAX_CHUNK, SSD_MAX_STATE, SWA_MAX_HEAD_DIM = 64, 128, 128
SSD_TC_CHUNK, SSD_TC_HEAD_DIM, SSD_TC_STATES = 64, 64, (16, 32, 64, 128)


def ssd_scan(x, dt, a, b, c, chunk: int = 64):
    """Chunked Mamba2 SSD scan from a zero state.

    x: (B, S, H, P) float32 or bfloat16 (read as float32); dt, a: (B, S, H)
    float32 (a = dt * A, A < 0); b, c: (B, S, N) float32, shared by all
    heads. S must be a multiple of ``chunk`` (callers pad). Returns
    (y (B, S, H, P) float32, final state (B, H, P, N) float32).

    Two routes, picked from the shapes before the launch (``_ssd_tc``; the
    C entries hold the same rule and each refuses the other's shapes, so
    neither is a fallback): chunk 64, P 64 and N 16, 32, 64 or 128 with
    x, b and c on 16-byte boundaries (Mamba2-130M, Hymba-1.5B) take the
    tensor-core kernels (``ssd_scan_tc``: c b^T once per chunk for all
    heads, every product on mma.sync over three-part bf16 splits, which
    needs 16-row tiles, 16-byte rows and one instantiation per N); every
    other shape takes the scalar kernels (``ssd_scan``), whose register
    tiles take any Q up to 64, any P and N up to 128. One call counts one
    launch of ``ssd_scan`` and one of its route in ``route_launches``.
    """
    name = "ssd_scan"
    bsz, s, h, p = x.shape
    if chunk < 1 or s % chunk:
        raise ValueError(f"{name}: sequence length {s} is not a multiple "
                         f"of chunk {chunk}")
    if _on_cpu(name, x, dt, a, b, c):
        return R.ssd_scan_ref(x, dt, a, b, c)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    _check(name, "x", x, 4)
    for what, t in (("dt", dt), ("a", a)):
        _check(name, what, t, 3, torch.float32)
        _require(name, tuple(t.shape) == (bsz, s, h),
                 f"{what} shape {tuple(t.shape)} != {(bsz, s, h)}")
    _check(name, "b", b, 3, torch.float32)
    _check(name, "c", c, 3, torch.float32)
    n = b.shape[-1]
    _require(name, tuple(b.shape) == (bsz, s, n) and c.shape == b.shape,
             "b/c shape mismatch")
    _require(name, chunk <= SSD_MAX_CHUNK and 1 <= n <= SSD_MAX_STATE,
             f"needs chunk <= {SSD_MAX_CHUNK} and N <= {SSD_MAX_STATE}, got "
             f"chunk {chunk}, N {n}")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, s, h, p), **f32)
    state = torch.empty((bsz, h, p, n), **f32)
    # scratch of both routes: each chunk's state contribution, which the
    # state pass overwrites with the state entering the chunk, and each
    # chunk's decay
    cs = torch.empty((bsz, h, s // chunk, p, n), **f32)
    decay = torch.empty((bsz, h, s // chunk), **f32)
    if not (bsz and h and p):
        return y, state
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(), cs.data_ptr(),
            decay.data_ptr())
    if _ssd_tc(x, b, c, chunk):
        # G = c b^T of every chunk, once for all heads (2 MB for Mamba2)
        gram = torch.empty((bsz, s // chunk, chunk, chunk), **f32)
        _launch(name, x.device, *args, gram.data_ptr(), bsz, s, h, p, n,
                chunk, _DTYPE_CODE[x.dtype], entry="ssd_scan_tc",
                route="tc")
    else:
        _launch(name, x.device, *args, bsz, s, h, p, n, chunk,
                _DTYPE_CODE[x.dtype], route="scalar")
    return y, state


def _ssd_tc(x, b, c, chunk: int) -> bool:
    """Whether an SSD scan takes the tensor-core route: chunk 64, P 64, N
    16, 32, 64 or 128 (one instantiation each), and x, b, c on 16-byte
    boundaries (16-byte loads of their rows). The C entries hold the same
    rule (``tc_takes``)."""
    return (chunk == SSD_TC_CHUNK and x.shape[-1] == SSD_TC_HEAD_DIM
            and b.shape[-1] in SSD_TC_STATES
            and all(t.data_ptr() % 16 == 0 for t in (x, b, c)))


def swa_attention(q, k, v, window: int, q_block: int = 128,
                  kv_block: int = 128):
    """Causal sliding-window attention (prefill), MHA layout: q, k, v
    (B, S, H, D) float32 or bfloat16 (callers repeat KV heads). Query i
    attends to keys j with ``i - window < j <= i``. As in the JAX wrapper,
    S must be a multiple of ``min(q_block, S)`` and ``min(kv_block, S)``;
    the CUDA kernel tiles on its own. Returns (B, S, H, D) in q's dtype.

    The C entry picks the kernel by shape before the launch: bfloat16 with
    D a multiple of 16 and q, k, v and out on 16-byte boundaries goes to a
    tensor-core kernel (mma.sync on 16 x 16 bf16 tiles); float32, and
    bfloat16 of other shapes, to the scalar kernel."""
    name = "swa_attention"
    bsz, s, h, d = q.shape
    qb, kb = min(q_block, s), min(kv_block, s)
    if qb < 1 or kb < 1 or s % qb or s % kb:
        raise ValueError(f"{name}: sequence length {s} is not a multiple of "
                         f"the blocks ({qb}, {kb})")
    if _on_cpu(name, q, k, v):
        return R.swa_attention_ref(q, k, v, window)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    _check(name, "q", q, 4)
    _check(name, "k", k, 4, q.dtype)
    _check(name, "v", v, 4, q.dtype)
    _require(name, k.shape == q.shape and v.shape == q.shape,
             "q/k/v shapes differ (MHA layout: repeat the KV heads)")
    _require(name, d <= SWA_MAX_HEAD_DIM,
             f"needs D <= {SWA_MAX_HEAD_DIM}, got {d}")
    out = torch.empty_like(q)
    if bsz and h and d:
        _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), bsz, s, h, d, min(int(window), s),
                1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype])
    return out
