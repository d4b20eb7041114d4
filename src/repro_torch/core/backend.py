"""Execution backends.

The scheduling core is backend-agnostic: the engine calls ``decode`` /
``copy_out`` / ``copy_in`` and the block hooks, and charges time from the
platform cost model. ``SimBackend`` is a no-op data plane (pure
discrete-event simulation). ``TorchBackend`` runs the model in PyTorch
against a real paged KV cache, on the card through the CUDA kernels of
``repro_torch.kernels``, and moves offloaded KV to pinned host memory and
back. It is the counterpart of ``repro.core.backend.JaxBackend`` for dense
archs without a sliding window.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models import model as M


class SimBackend:
    """Cost-model-only backend (the default for benchmarks)."""

    def prefill(self, reqs):
        pass

    def decode(self, reqs):
        pass

    def copy_out(self, req):
        pass

    def copy_in(self, req):
        pass

    def copy_blocks(self, src, dst, device=0):
        pass

    def promote_blocks(self, host_blocks, gpu_blocks):
        pass

    def offload_blocks(self, gpu_blocks, host_blocks):
        pass

    def invalidate(self, rid):
        pass

    def generated_tokens(self, rid):
        """Decoded token ids for a request, or None when this backend
        does not materialize tokens."""
        return None


def _bucket(n: int) -> int:
    """Next power of two >= n: batch and table shapes are padded to these
    buckets, as in the JAX backend, so both run the same shapes."""
    return 1 << (max(n, 1) - 1).bit_length()


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def paged_prefill_chunks(cfg, params, cache, entries, chunk: int = 32):
    """Chunked, bucketed, batched suffix-only paged prefill.

    ``entries``: list of (blocks, tokens, cached) per request: the block
    table, the full target cache-token list, and the leading token count
    already resident in the pool (shared prefix; token-granular, so the
    suffix may start mid-block). Computes and writes only
    ``tokens[cached:]`` per request, ``chunk`` tokens per step, shapes
    padded to power-of-two buckets; writes ``cache.k/v`` in place.
    Returns the final-suffix-position hidden row per entry (None when the
    suffix is empty)."""
    suffix = [toks[cached:] for _, toks, cached in entries]
    last_h = [None] * len(entries)
    s_max = max((len(s) for s in suffix), default=0)
    if s_max == 0:
        return last_h
    dev = cache.device
    bs = cache.block_size
    bb = _bucket(len(entries))
    pb = _bucket(max(len(blocks) for blocks, _, _ in entries))
    tables = np.zeros((bb, pb), np.int32)
    for i, (blocks, _, _) in enumerate(entries):
        tables[i, :len(blocks)] = blocks
    ttables = _to(tables, dev)
    C = min(chunk, _bucket(s_max))
    pp = (C - 1) // bs + 2      # max pages a C-token window can straddle
    for c0 in range(0, s_max, C):
        tok = np.zeros((bb, C), np.int32)
        qpos = np.full((bb, C), -1, np.int32)
        wpages = np.full((bb, pp), cache.scratch_block, np.int32)
        wstart = np.zeros((bb,), np.int32)
        wcount = np.zeros((bb,), np.int32)
        for i, (blocks, toks, cached) in enumerate(entries):
            n = min(len(suffix[i]) - c0, C)
            if n <= 0:
                continue
            tok[i, :n] = suffix[i][c0:c0 + n]
            qpos[i, :n] = cached + c0 + np.arange(n)
            wpages[i], wstart[i] = cache.write_window(
                blocks, cached + c0, n, pp)
            wcount[i] = n
        h = M.paged_prefill_step(
            cfg, params, cache.k, cache.v, _to(tok, dev), ttables,
            _to(qpos, dev), _to(wpages, dev), _to(wstart, dev),
            _to(wcount, dev))
        for i, s in enumerate(suffix):
            if c0 <= len(s) - 1 < c0 + C:
                last_h[i] = h[i, len(s) - 1 - c0]
    return last_h


class TorchBackend:
    """Real compute: the model in PyTorch, real paged KV, real host offload.

    Each engine request maps to a row in a bucketed batch of block tables.
    One decode iteration is one ``models.model.paged_decode_step``: a loop
    over the stacked layers with the batched KV token-write kernel and the
    paged-attention kernel, no per-request Python in the write or attend
    path. Runs on ``device`` ("cuda" unless the caller asks for "cpu");
    ``params`` overrides the weights drawn from ``seed`` (the tests pass
    weights converted from the JAX backend).
    """

    def __init__(self, cfg, engine_cfg, platform, seed: int = 0,
                 device="cuda", params=None):
        if cfg.arch_type != "dense" or cfg.sliding_window is not None:
            raise NotImplementedError(
                f"{cfg.name}: TorchBackend serves dense archs without a "
                "sliding window; MoE, windowed, SSM, hybrid, VLM and audio "
                "archs come in later slices of the port")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchBackend(device='cuda') found no CUDA "
                               "device; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.device = device
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = M.init_params(cfg, gen, device)
        self.params = params
        self.cache = PagedKVCache(cfg, engine_cfg.gpu_blocks,
                                  platform.block_tokens,
                                  host_blocks=engine_cfg.host_blocks,
                                  dtype=M.torch_dtype(cfg),
                                  host_precision=(
                                      engine_cfg.temporal.kv_precision),
                                  device=device)
        self.block_tokens = platform.block_tokens
        self.generated: Dict[str, List[int]] = {}
        # tokens actually resident in the paged cache per request (the
        # engine's context_len is only refreshed at quantum boundaries)
        self.cache_len: Dict[str, int] = {}
        # block ids the prefill was written into: a mismatch with the
        # request's current blocks means it was preempted and re-admitted
        # with fresh blocks -> re-prefill; copy_in refreshes it
        self._prefill_sig: Dict[str, Tuple[int, ...]] = {}
        # prompt tokens dropped because they exceeded the block allocation
        # (never silent: counted here and warned about)
        self.truncated_prompt_tokens = 0
        # final-position prefill logits per request (inspection / tests)
        self.last_prefill_logits: Dict[str, np.ndarray] = {}
        # suffix tokens per prefill step (bucketed)
        self.prefill_chunk = 32

    # -- engine hooks ----------------------------------------------------------
    def decode(self, reqs):
        reqs = [r for r in reqs if r.num_gpu_blocks > 0]
        if not reqs:
            return
        need = [r for r in reqs if self._needs_prefill(r)]
        if need:
            self._prefill_batch(need)
        self._decode_batch(reqs)

    def _needs_prefill(self, r) -> bool:
        sig = self._prefill_sig.get(r.rid)
        return sig is None or tuple(r.gpu_blocks[:len(sig)]) != sig

    def copy_blocks(self, src: List[int], dst: List[int], device: int = 0):
        """Engine hook: COW clone of shared prefix blocks (device 0 only;
        tensor-parallel mirror copies are accounting-only here)."""
        if device == 0:
            self.cache.copy_blocks(src, dst)

    def promote_blocks(self, host_blocks: List[int], gpu_blocks: List[int]):
        """Engine hook: host-tier prefix promotion, the same H2D data plane
        request uploads ride."""
        self.cache.upload(host_blocks, gpu_blocks)

    def offload_blocks(self, gpu_blocks: List[int], host_blocks: List[int]):
        """Engine hook: session-tier D2H save of blocks no live request
        owns, the same data plane ``copy_out`` uses."""
        self.cache.offload(gpu_blocks, host_blocks)

    def generated_tokens(self, rid: str) -> Optional[List[int]]:
        """Decoded token ids so far."""
        gen = self.generated.get(rid)
        return list(gen) if gen is not None else None

    def invalidate(self, rid: str):
        """Engine hook: the request's device blocks were released or it
        finished. Drop the cache bookkeeping so a re-admission re-prefills
        even if the allocator hands back the same block ids. ``generated``
        survives: it is the output and the recompute source."""
        self._prefill_sig.pop(rid, None)
        self.cache_len.pop(rid, None)
        self.last_prefill_logits.pop(rid, None)

    def copy_out(self, req):
        # only the private blocks move; the leading shared-prefix blocks
        # stay resident on device
        self.cache.offload(req.gpu_blocks[req.shared_prefix_blocks:],
                           req.host_blocks)

    def copy_in(self, req):
        self.cache.upload(req.host_blocks, req.reserved_upload_blocks)
        sig = self._prefill_sig.get(req.rid)
        if sig is not None:
            # post-upload table = resident shared-prefix blocks + the
            # freshly uploaded private blocks
            full = req.gpu_blocks + list(req.reserved_upload_blocks)
            self._prefill_sig[req.rid] = tuple(full[:len(sig)])

    # -- internals --------------------------------------------------------------
    def _prefill_tokens(self, req):
        """Target cache-token list for a (re)prefill, plus the leading
        token count already resident in shared prefix blocks.

        Recompute path (preempted request): reproduce the cache decode
        would have built. Decode writes its *input* token's KV at the
        current cache length, so position len(p) holds a duplicate of the
        last prompt token, positions after it hold generated[:-1], and the
        newest generated token is the pending decode input. Generated
        tokens that no longer fit the allocation are rolled back (greedy
        decode regenerates them identically)."""
        toks = [t % self.cfg.vocab_size for t in req.prompt_tokens]
        gen = self.generated.get(req.rid, [])
        cap = len(req.gpu_blocks) * self.block_tokens
        if gen and toks:
            keep = max(cap - len(toks), 0)
            if len(gen) > keep:
                gen = gen[:keep]
                self.generated[req.rid] = list(gen)
            if gen:
                toks = toks + [toks[-1]] + gen[:-1]
        if len(toks) > cap:
            dropped = len(toks) - cap
            self.truncated_prompt_tokens += dropped
            warnings.warn(
                f"prefill truncation: {req.rid} drops {dropped} prompt "
                f"tokens ({len(toks)} tokens vs {cap} cache capacity); "
                "admission under-sized the allocation")
            toks = toks[:cap]
        cached = min(getattr(req, "prefix_cached_tokens", 0), len(toks))
        return toks, cached

    def _prefill_batch(self, reqs):
        """Batched chunked suffix-only prefill: cached prefix KV is read
        through the block tables, only each request's uncached suffix is
        computed and written (see ``paged_prefill_chunks``)."""
        bs = self.block_tokens
        items = [(r, *self._prefill_tokens(r)) for r in reqs]
        last_h = paged_prefill_chunks(
            self.cfg, self.params, self.cache,
            [(r.gpu_blocks, toks, cached) for r, toks, cached in items],
            chunk=self.prefill_chunk)
        rows = [i for i, x in enumerate(last_h) if x is not None]
        if rows:
            # padded to the batch bucket, as the JAX backend does
            stack = [last_h[i] for i in rows]
            stack += [stack[0]] * (_bucket(len(items)) - len(rows))
            logits = M.head_logits(self.cfg, self.params, torch.stack(stack))
            arr = logits[:len(rows)].float().cpu().numpy()
            for j, i in enumerate(rows):
                self.last_prefill_logits[items[i][0].rid] = arr[j]
        for r, toks, _ in items:
            n_blocks = -(-len(toks) // bs) if toks else 0
            self._prefill_sig[r.rid] = tuple(r.gpu_blocks[:n_blocks])
            self.cache_len[r.rid] = len(toks)

    def _decode_batch(self, reqs):
        bs = self.block_tokens
        b = len(reqs)
        bb = _bucket(b)
        pb = _bucket(max(len(r.gpu_blocks) for r in reqs))
        tables = np.zeros((bb, pb), np.int32)
        positions = np.zeros((bb,), np.int32)
        attn_lens = np.zeros((bb,), np.int32)
        toks = np.zeros((bb,), np.int32)
        # padded rows and full-capacity rows write into the scratch block
        slots = np.full((bb,), self.cache.scratch_slot, np.int32)
        wrote = np.zeros((b,), bool)
        for i, r in enumerate(reqs):
            blocks = r.gpu_blocks
            tables[i, :len(blocks)] = blocks
            cl = min(self.cache_len.get(r.rid, 0), len(blocks) * bs)
            prev = self.generated.get(r.rid) or [t % self.cfg.vocab_size
                                                 for t in r.prompt_tokens[-1:]]
            toks[i] = prev[-1]
            positions[i] = cl
            slots[i] = self.cache.slot_of(blocks, cl)
            wrote[i] = slots[i] != self.cache.scratch_slot
            # exactly-full rows drop the new token's KV (scratch write) and
            # attend over the existing context only
            attn_lens[i] = cl + (1 if wrote[i] else 0)
        dev = self.device
        logits = M.paged_decode_step(
            self.cfg, self.params, self.cache.k, self.cache.v,
            *(_to(a, dev) for a in (toks, tables, positions, attn_lens,
                                    slots)))
        nxt = torch.argmax(logits[:b], dim=-1).cpu().numpy()
        for i, r in enumerate(reqs):
            self.generated.setdefault(r.rid, []).append(int(nxt[i]))
            if wrote[i]:
                self.cache_len[r.rid] = int(positions[i]) + 1
