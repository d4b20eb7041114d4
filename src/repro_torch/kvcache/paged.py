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
to the card and scatters them into the pools.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.kernels import ops


class PagedKVCache:
    def __init__(self, cfg, num_blocks: int, block_size: int,
                 host_blocks: int = 0, dtype=torch.bfloat16,
                 host_precision: str = "fp16", device="cuda"):
        if host_precision == "int8_host":
            raise NotImplementedError(
                "host_precision='int8_host' needs the fused quantizing "
                "migration kernels, which a later slice of the port adds")
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
        if host_blocks <= 0:
            self.host_k = self.host_v = None
        else:
            pin = self.device.type == "cuda"
            hshape = (nl, host_blocks, block_size, hkv, dh)
            self.host_k = torch.zeros(hshape, dtype=dtype, pin_memory=pin)
            self.host_v = torch.zeros(hshape, dtype=dtype, pin_memory=pin)

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
        across every layer in one kernel launch per tensor."""
        bs = self.block_size
        nl, s = k_seq.shape[:2]
        n = -(-s // bs)
        pad = n * bs - s
        if pad:
            k_seq = torch.nn.functional.pad(k_seq, (0, 0, 0, 0, 0, pad))
            v_seq = torch.nn.functional.pad(v_seq, (0, 0, 0, 0, 0, pad))
        kb = k_seq.reshape(nl, n, bs, *k_seq.shape[2:]).to(self.k.dtype)
        vb = v_seq.reshape(nl, n, bs, *v_seq.shape[2:]).to(self.v.dtype)
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
        tensor) and copy them into host pages ``host_blocks``."""
        self._require_host("offload()")
        idx = self._ids(gpu_blocks)
        hidx = torch.as_tensor(np.asarray(host_blocks, np.int64))
        staged = [ops.block_gather_layers(pool, idx)
                  for pool in (self.k, self.v)]
        if self.device.type == "cuda":
            hosts = []
            for s in staged:
                h = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                h.copy_(s, non_blocking=True)
                hosts.append(h)
            # the D2H copies must land before the host pool reads them
            torch.cuda.current_stream(self.device).synchronize()
            staged = hosts
        self.host_k.index_copy_(1, hidx, staged[0])
        self.host_v.index_copy_(1, hidx, staged[1])

    def upload(self, host_blocks: List[int], gpu_blocks: List[int]):
        """H2D: read host pages, scatter them into (possibly new) device
        blocks across every layer, one kernel launch per tensor."""
        self._require_host("upload()")
        idx = self._ids(gpu_blocks)
        hidx = torch.as_tensor(np.asarray(host_blocks, np.int64))
        for pool, host in ((self.k, self.host_k), (self.v, self.host_v)):
            shape = (host.shape[0], len(host_blocks)) + tuple(host.shape[2:])
            stage = torch.empty(shape, dtype=host.dtype,
                                pin_memory=self.device.type == "cuda")
            torch.index_select(host, 1, hidx, out=stage)
            ops.block_scatter_layers(
                pool, idx, stage.to(self.device, non_blocking=True))
