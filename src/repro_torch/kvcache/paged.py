"""Paged KV cache: device pools and a host pool, driven by the block ids
that ``repro_torch.core.block_pool`` hands out.

Layout (per model): k/v pools of shape (L, N+1, bs, Hkv, D). The attention
and write kernels view one layer (N+1, bs, Hkv, D); the migration kernels
move whole (L, bs, Hkv, D) block columns per block id, so one logical
block id covers every layer.

Row ``N`` (``scratch_block``) is never handed out by the allocator: it is
the sink of masked writes (padded batch rows, and sequences whose blocks
are exactly full), so an out-of-room token can never land in a live block.

Every method writes the pools **in place**. On a CUDA device the host pool
is pinned CPU memory: an offload gathers the blocks on the card, copies
them into pinned staging and waits for that copy to finish before it fills
the host pool; an upload stages host blocks in pinned memory, copies them
to the card and scatters them into the pools. Each of these phases is a
``repro_torch.trace`` span (``tc.kv.offload.*``, ``tc.kv.upload.*``).

``host_precision="int8_host"`` keeps the host pool as int8 payload plus
float32 scales per (layer, block, kv head), half the fp16 bytes on every
wire; the device pools keep ``dtype``. The offload's gather quantizes on
the card (``block_gather_quant_layers``), so only int8 and scales cross to
the host; the upload's scatter dequantizes on the card
(``block_scatter_dequant_layers``), so attention never sees int8.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels import ops


class PagedKVCache:
    def __init__(self, cfg, num_blocks: int, block_size: int,
                 host_blocks: int = 0, dtype=torch.bfloat16,
                 host_precision: str = "fp16", device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.scratch_block = num_blocks          # masked-write sink (row N)
        self.host_precision = host_precision
        nl, hkv, dh = cfg.num_layers, max(cfg.num_kv_heads, 1), \
            max(cfg.head_dim, 1)
        shape = (nl, num_blocks + 1, block_size, hkv, dh)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        # host_blocks=0 means the tier is off: allocate nothing, so a
        # misrouted offload fails loudly instead of landing somewhere
        self.host_scales_k = self.host_scales_v = None
        if host_blocks <= 0:
            self.host_k = self.host_v = None
            return
        pin = self.device.type == "cuda"
        hshape = (nl, host_blocks, block_size, hkv, dh)
        hdtype = torch.int8 if host_precision == "int8_host" else dtype
        self.host_k = torch.zeros(hshape, dtype=hdtype, pin_memory=pin)
        self.host_v = torch.zeros(hshape, dtype=hdtype, pin_memory=pin)
        if host_precision == "int8_host":
            self.host_scales_k = torch.zeros(
                (nl, host_blocks, hkv), dtype=torch.float32, pin_memory=pin)
            self.host_scales_v = torch.zeros(
                (nl, host_blocks, hkv), dtype=torch.float32, pin_memory=pin)

    def _require_host(self, op: str) -> None:
        if self.host_k is None:
            raise RuntimeError(
                f"host tier is disabled (host_blocks=0) but {op} was "
                "reached — the engine must not route offload/upload "
                "traffic to a cache constructed without a host pool")

    def _ids(self, blocks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(blocks, np.int32)).to(self.device)

    @property
    def scratch_slot(self) -> int:
        """Absolute slot id of the masked-write sink (offset 0)."""
        return self.scratch_block * self.block_size

    def slot_of(self, blocks: List[int], pos: int) -> int:
        """Absolute slot id for token position ``pos`` of a request, or the
        scratch slot when the position falls past the allocated blocks."""
        bs = self.block_size
        if 0 <= pos < len(blocks) * bs:
            return blocks[pos // bs] * bs + pos % bs
        return self.scratch_slot

    def write_window(self, blocks: List[int], start: int, count: int,
                     max_pages: int):
        """Suffix-write window for ``count`` consecutive tokens beginning
        at absolute position ``start``: the ordered destination pages,
        padded with the scratch block to ``max_pages``, and the in-page
        offset of the first token (the ``kv_chunk_write`` contract)."""
        bs = self.block_size
        pages = np.full((max_pages,), self.scratch_block, np.int32)
        first = start // bs
        npages = (start % bs + count + bs - 1) // bs
        pages[:npages] = blocks[first:first + npages]
        return pages, start % bs

    # ---- write path ---------------------------------------------------------
    def write_prefill(self, blocks: List[int], k_seq, v_seq):
        """k_seq/v_seq: (L, S, Hkv, D) for one request; scatter into blocks
        across every layer in one kernel launch per tensor. Where S spans
        more blocks than the request holds (a VLM's K/V covers its patches
        ahead of the text), the leading blocks are written and the rest is
        dropped, as the JAX scatter's grid over the given blocks does."""
        bs = self.block_size
        nl, s = k_seq.shape[:2]
        n = -(-s // bs)
        pad = n * bs - s
        if pad:
            k_seq = torch.nn.functional.pad(k_seq, (0, 0, 0, 0, 0, pad))
            v_seq = torch.nn.functional.pad(v_seq, (0, 0, 0, 0, 0, pad))
        m = len(blocks[:n])
        kb = k_seq.reshape(nl, n, bs, *k_seq.shape[2:])[:, :m].to(
            self.k.dtype)
        vb = v_seq.reshape(nl, n, bs, *v_seq.shape[2:])[:, :m].to(
            self.v.dtype)
        idx = self._ids(blocks[:n])
        ops.block_scatter_layers(self.k, idx, kb.contiguous())
        ops.block_scatter_layers(self.v, idx, vb.contiguous())

    def write_tokens(self, slots, k_toks, v_toks):
        """Batched decode write: k_toks/v_toks (L, B, Hkv, D); slots (B,)
        absolute slot ids (scratch slot = masked). One kernel launch for
        every (layer, sequence) pair."""
        nl, nb = self.k.shape[:2]
        bs = self.block_size
        slots = torch.as_tensor(slots, dtype=torch.int32).to(self.device)
        # fold layers into the page axis: layer l's block b is folded
        # block l*(N+1)+b
        kf = self.k.view(nl * nb, bs, *self.k.shape[3:])
        vf = self.v.view(nl * nb, bs, *self.v.shape[3:])
        layer_base = (torch.arange(nl, dtype=torch.int32,
                                   device=self.device) * (nb * bs))[:, None]
        folded = (layer_base + slots[None, :]).reshape(-1)
        kn = k_toks.reshape(-1, *k_toks.shape[2:]).to(self.k.dtype)
        vn = v_toks.reshape(-1, *v_toks.shape[2:]).to(self.v.dtype)
        ops.kv_token_write(kf, vf, kn.contiguous(), vn.contiguous(), folded)

    def write_token(self, blocks: List[int], pos: int, k_tok, v_tok):
        """k_tok/v_tok: (L, Hkv, D); write at absolute position ``pos`` of
        the request holding ``blocks`` (the scratch slot past them)."""
        self.write_tokens([self.slot_of(blocks, pos)], k_tok[:, None],
                          v_tok[:, None])

    # ---- read path ----------------------------------------------------------
    def gather_seq(self, blocks: List[int], length: int):
        """One request's K and V, each (L, length, Hkv, D): its blocks of
        every layer in one gather launch per pool (the offload's
        ``block_gather_layers``), then the first ``length`` positions."""
        nl = self.k.shape[0]
        idx = self._ids(blocks)
        return tuple(
            ops.block_gather_layers(pool, idx)
            .reshape(nl, -1, *pool.shape[3:])[:, :length]
            for pool in (self.k, self.v))

    def decode_attention(self, layer: int, q, block_tables, context_lens):
        """Batched paged decode attention over layer ``layer``'s pools:
        q (B, H, D), block_tables (B, P) int32, context_lens (B,) int32;
        rows with ``context_lens`` 0 come out as zeros."""
        return ops.paged_attention(q, self.k[layer], self.v[layer],
                                   block_tables, context_lens)

    # ---- copy-on-write ------------------------------------------------------
    def copy_blocks(self, src: List[int], dst: List[int]):
        """Device-local block clone, all layers: the COW data plane (a
        request forking off a shared prefix block gets a private copy)."""
        si, di = self._ids(src), self._ids(dst)
        ops.block_scatter_layers(self.k, di,
                                 ops.block_gather_layers(self.k, si))
        ops.block_scatter_layers(self.v, di,
                                 ops.block_gather_layers(self.v, si))

    # ---- migration (paper §6.3) ---------------------------------------------
    def offload(self, gpu_blocks: List[int], host_blocks: List[int]):
        """D2H: gather device blocks (all layers, one kernel launch per
        tensor) and copy them into host pages ``host_blocks``. An
        ``int8_host`` tier quantizes inside the gather, so the copy moves
        the int8 payload and its scales."""
        self._require_host("offload()")
        idx = self._ids(gpu_blocks)
        hidx = torch.as_tensor(np.asarray(host_blocks, np.int64))
        with trace.span("tc.kv.offload.gather"):
            if self.host_precision == "int8_host":
                (kq, ks), (vq, vs) = (
                    ops.block_gather_quant_layers(pool, idx)
                    for pool in (self.k, self.v))
                staged = [kq, vq, ks, vs]
                dests = [self.host_k, self.host_v, self.host_scales_k,
                         self.host_scales_v]
            else:
                staged = [ops.block_gather_layers(pool, idx)
                          for pool in (self.k, self.v)]
                dests = [self.host_k, self.host_v]
        if self.device.type == "cuda":
            with trace.span("tc.kv.offload.pin"):
                hosts = []
                for s in staged:
                    h = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                    h.copy_(s, non_blocking=True)
                    hosts.append(h)
            # the D2H copies must land before the host pool reads them
            with trace.span("tc.kv.offload.wait"):
                torch.cuda.current_stream(self.device).synchronize()
            staged = hosts
        with trace.span("tc.kv.offload.host_copy"):
            for dest, s in zip(dests, staged):
                dest.index_copy_(1, hidx, s)

    def upload(self, host_blocks: List[int], gpu_blocks: List[int]):
        """H2D: read host pages, scatter them into (possibly new) device
        blocks across every layer, one kernel launch per tensor. An
        ``int8_host`` tier moves the int8 payload and its scales and
        dequantizes inside the scatter."""
        self._require_host("upload()")
        idx = self._ids(gpu_blocks)
        hidx = torch.as_tensor(np.asarray(host_blocks, np.int64))

        quant = self.host_precision == "int8_host"

        def stage(host):
            shape = (host.shape[0], len(host_blocks)) + tuple(host.shape[2:])
            out = torch.empty(shape, dtype=host.dtype,
                              pin_memory=self.device.type == "cuda")
            torch.index_select(host, 1, hidx, out=out)
            return out

        # one pool at a time, so the device holds one pool's staging
        for pool, host, scales in (
                (self.k, self.host_k, self.host_scales_k),
                (self.v, self.host_v, self.host_scales_v)):
            with trace.span("tc.kv.upload.stage"):
                pinned = [stage(host)] + ([stage(scales)] if quant else [])
            with trace.span("tc.kv.upload.scatter"):
                dev = [p.to(self.device, non_blocking=True) for p in pinned]
                if quant:
                    ops.block_scatter_dequant_layers(pool, idx, *dev)
                else:
                    ops.block_scatter_layers(pool, idx, *dev)
