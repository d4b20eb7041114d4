"""Public wrappers for the serving-path kernels.

Each wrapper dispatches on the device of its tensors. On the CPU it runs
the plain PyTorch version from ``ref``; on a CUDA tensor it checks device,
dtype (float32 or bfloat16), shape and contiguity, allocates any output
with ``torch.empty``, launches its hand-written kernel from ``csrc/`` on
the current stream, and raises if the launch is refused. It never falls
back to the plain version on the card.

The write wrappers (``kv_token_write``, ``kv_chunk_write``,
``block_scatter_layers``) update the pools **in place** and return them.

``launches[name]`` counts the kernel launches of each wrapper (CPU calls
are not counted); ``reset_launches`` sets every count to 0.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as R

KERNELS = ("kv_token_write", "paged_attention", "kv_chunk_write",
           "paged_prefill_attention", "block_gather_layers",
           "block_scatter_layers")
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# query rows per paged-prefill thread block
PREFILL_Q_TILE = 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float
_SIGNATURES = {
    "kv_token_write": ("kv_write", [_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                    _P]),
    "kv_chunk_write": ("kv_write", [_P, _P, _P, _P, _P, _P, _P, _I64, _I,
                                    _I, _I, _I64, _I64, _P]),
    "block_gather_layers": ("block_copy", [_P, _P, _P, _I64, _I64, _I64,
                                           _I64, _P]),
    "block_scatter_layers": ("block_copy", [_P, _P, _P, _I64, _I64, _I64,
                                            _I64, _P]),
    "paged_attention": ("paged_attention", [_P, _P, _P, _P, _P, _P, _I64,
                                            _I, _I, _I, _I, _I, _F, _I,
                                            _P]),
    "paged_prefill_attention": ("paged_prefill",
                                [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _I, _P]),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib_name, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(lib_name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    if device.index is not None and \
            device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {device}, but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    rc = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    launches[name] += 1


def _on_cpu(name: str, *tensors) -> bool:
    """True when every tensor is on the CPU; raises unless they all share
    one CUDA device otherwise."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or len(devs) != 1:
        raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
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
# decode: B1 kv_token_write, B2 paged_attention
# ---------------------------------------------------------------------------

def kv_token_write(k_pages, v_pages, k_new, v_new, slots):
    """Write one token's K/V per sequence into the pools, in place.

    k_pages/v_pages: (N, bs, Hkv, D); k_new/v_new: (B, Hkv, D) of the pool
    dtype; slots: (B,) int32 absolute slot ids (block * bs + offset).
    Returns (k_pages, v_pages).
    """
    name = "kv_token_write"
    if _on_cpu(name, k_pages, v_pages, k_new, v_new, slots):
        return R.kv_token_write_ref(k_pages, v_pages, k_new, v_new, slots)
    _check_pools(name, k_pages, v_pages)
    n, bs, hkv, d = k_pages.shape
    _check(name, "k_new", k_new, 3, k_pages.dtype)
    _check(name, "v_new", v_new, 3, k_pages.dtype)
    _check(name, "slots", slots, 1, torch.int32)
    b = k_new.shape[0]
    _require(name, k_new.shape == (b, hkv, d) and v_new.shape == k_new.shape
             and slots.shape == (b,), "shape mismatch")
    if b:
        _launch(name, k_pages.device, k_pages.data_ptr(),
                v_pages.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                slots.data_ptr(), b, n * bs, hkv * d * k_pages.element_size())
    return k_pages, v_pages


def paged_attention(q, k_pages, v_pages, block_tables, context_lens):
    """Decode attention: q (B, H, D) over pools (N, bs, Hkv, D) through
    block_tables (B, P) int32, attending to positions < context_lens (B,)
    int32. Rows with context_lens = 0 give zeros. Returns (B, H, D)."""
    name = "paged_attention"
    if _on_cpu(name, q, k_pages, v_pages, block_tables, context_lens):
        return R.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                     context_lens)
    code = _check_pools(name, k_pages, v_pages)
    _, bs, hkv, d = k_pages.shape
    _check(name, "q", q, 3, k_pages.dtype)
    _check(name, "block_tables", block_tables, 2, torch.int32)
    _check(name, "context_lens", context_lens, 1, torch.int32)
    b, h, _ = q.shape
    _require(name, q.shape[2] == d and h % hkv == 0
             and block_tables.shape[0] == b and context_lens.shape == (b,),
             "shape mismatch")
    g = h // hkv
    _require(name, g <= 16 and d <= 256 and bs <= 256,
             "needs H/Hkv <= 16, D <= 256 and bs <= 256")
    out = torch.empty_like(q)
    if b:
        _launch(name, q.device, q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                context_lens.data_ptr(), out.data_ptr(), b,
                block_tables.shape[1], bs, hkv, g, d, 1.0 / math.sqrt(d),
                code)
    return out


# ---------------------------------------------------------------------------
# prefill: B3 kv_chunk_write, B4 paged_prefill_attention
# ---------------------------------------------------------------------------

def kv_chunk_write(k_pages, v_pages, k_new, v_new, wpages, wstart, wcount):
    """Write one suffix chunk per sequence into the pools, in place.

    k_pages/v_pages: (N, bs, Hkv, D); k_new/v_new: (B, C, Hkv, D) of the
    pool dtype; wpages: (B, PP) int32 destination pages of each row's write
    window in order; wstart: (B,) int32 in-page offset of the first token;
    wcount: (B,) int32 valid tokens per row (later tokens are not written).
    Returns (k_pages, v_pages).
    """
    name = "kv_chunk_write"
    if _on_cpu(name, k_pages, v_pages, k_new, v_new, wpages, wstart, wcount):
        return R.kv_chunk_write_ref(k_pages, v_pages, k_new, v_new, wpages,
                                    wstart, wcount)
    _check_pools(name, k_pages, v_pages)
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
    if b and c:
        _launch(name, k_pages.device, k_pages.data_ptr(),
                v_pages.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                wpages.data_ptr(), wstart.data_ptr(), wcount.data_ptr(), b, c,
                wpages.shape[1], bs, n, hkv * d * k_pages.element_size())
    return k_pages, v_pages


def paged_prefill_attention(q, k_pages, v_pages, block_tables, q_pos):
    """Chunked suffix-prefill attention: q (B, C, H, D) at absolute
    positions q_pos (B, C) int32 attends to pool positions <= q_pos
    through block_tables (B, P) int32; q_pos = -1 rows give zeros.
    Returns (B, C, H, D)."""
    name = "paged_prefill_attention"
    if _on_cpu(name, q, k_pages, v_pages, block_tables, q_pos):
        return R.paged_prefill_attention_ref(q, k_pages, v_pages,
                                             block_tables, q_pos)
    code = _check_pools(name, k_pages, v_pages)
    _, bs, hkv, d = k_pages.shape
    _check(name, "q", q, 4, k_pages.dtype)
    _check(name, "block_tables", block_tables, 2, torch.int32)
    _check(name, "q_pos", q_pos, 2, torch.int32)
    b, c, h, _ = q.shape
    _require(name, q.shape[3] == d and h % hkv == 0
             and block_tables.shape[0] == b and q_pos.shape == (b, c),
             "shape mismatch")
    _require(name, h // hkv <= 16 and d % 4 == 0 and bs % 4 == 0,
             "needs H/Hkv <= 16 and D, bs multiples of 4")
    out = torch.empty_like(q)
    if b and c:
        _launch(name, q.device, q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                q_pos.data_ptr(), out.data_ptr(), b, c,
                block_tables.shape[1], bs, hkv, h // hkv, d, PREFILL_Q_TILE,
                1.0 / math.sqrt(d), code)
    return out


# ---------------------------------------------------------------------------
# migration: B5 block_gather_layers, B6 block_scatter_layers
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
