"""Execution backends.

The scheduling core is backend-agnostic: the engine calls ``decode`` /
``copy_out`` / ``copy_in`` and the block hooks, and charges time from the
platform cost model. ``SimBackend`` is a no-op data plane (pure
discrete-event simulation). ``TorchBackend`` runs the model in PyTorch
against a real paged KV cache, on the card through the CUDA kernels of
``repro_torch.kernels``, and moves offloaded KV to pinned host memory and
back. It is the counterpart of ``repro.core.backend.JaxBackend`` and takes
every arch it takes, with its semantics: dense and MoE archs without a
sliding window prefill in batched paged chunks (dense archs in replays of
up to ``PREFILL_TOKENS`` positions of the rows whose suffix is left, MoE
archs in the JAX backend's lock step), every other arch one request at a
time through the dense-cache ``prefill``, whose K/V is
written into the paged pool; SSM and audio archs decode no token on this
path. On the card each padded step
shape runs as one CUDA graph (``models.graphs.StepGraphs``, the counterpart of the
JAX backend's jitted steps); on the CPU the steps run eagerly. ``TemporalConfig(kv_precision=
"int8_host")`` gives the cache an int8 host tier: ``copy_out`` and
``offload_blocks`` quantize on the card before the D2H copy, ``copy_in``
and ``promote_blocks`` dequantize on the card after the H2D copy.
The decode step and the prefill open ``repro_torch.trace`` spans and
stamp the start of each request's prefill; the tracer is off unless a
caller enables it.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models import graphs as G
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


# suffix positions one replay of the dense archs' prefill holds at most
PREFILL_TOKENS = 256
# the lock-step chunk of the MoE archs' prefill, and the least chunk of a
# dense replay
PREFILL_CHUNK = 32


def paged_prefill_chunks(step, cache, entries, chunk: int = PREFILL_CHUNK,
                         budget: Optional[int] = None):
    """Chunked, bucketed, batched suffix-only paged prefill.

    ``step(tokens, tables, q_pos, wpages, wstart, wcount)`` runs one
    replay from int32 numpy inputs and returns its hidden states (the
    prefill of ``models.graphs.EagerSteps`` or ``StepGraphs`` with the
    params and pools bound); a replayed graph returns the same static
    output every call, so the rows kept here are copies.

    ``entries``: list of (blocks, tokens, cached) per request: the block
    table, the full target cache-token list, and the leading token count
    already resident in the pool (shared prefix; token-granular, so the
    suffix may start mid-block). Computes and writes only
    ``tokens[cached:]`` per request, shapes padded to power-of-two
    buckets; writes ``cache.k/v`` in place. Two plans:

    * ``budget=None``, lock step (the JAX backend's plan): every replay
      runs the call's whole padded batch ``chunk`` tokens on, rows whose
      suffix has ended masked by ``q_pos = -1``; C = min(chunk, bucket of
      the longest suffix).
    * ``budget=T``: each replay carries only the rows whose suffix still
      has tokens, in a batch bucket ``bb`` of their own, with the subset's
      block tables: C = max(chunk, T // bb) positions a row, at most
      ``max(T, bb * chunk)`` in all, while a row has more than ``chunk``
      tokens left, then the lock step's C. Two sizes of C a batch bucket
      keep the CUDA graphs few (each holds its own pool of temporaries);
      below the GEMMs' ridge point a replay's padded positions cost little
      time.

    Returns the final-suffix-position hidden row per entry (None when the
    suffix is empty). Each replay is two tracer spans:
    ``tc.prefill.inputs`` (its padded inputs) and ``tc.prefill.launch``
    (the step)."""
    suffix = [toks[cached:] for _, toks, cached in entries]
    last_h = [None] * len(entries)
    done = [0] * len(entries)
    bs = cache.block_size
    lockstep = min(chunk, _bucket(max((len(s) for s in suffix), default=0)))
    while True:
        left = [len(s) - d for s, d in zip(suffix, done)]
        live = [i for i, n in enumerate(left) if n > 0]
        if not live:
            return last_h
        if budget is None:
            rows, C = range(len(entries)), lockstep
        else:
            rows = live
            C = (max(chunk, budget // _bucket(len(rows)))
                 if max(left[i] for i in rows) > chunk else lockstep)
        bb = _bucket(len(rows))
        pb = _bucket(max(len(entries[i][0]) for i in rows))
        pp = (C - 1) // bs + 2      # max pages a C-token window can straddle
        with trace.span("tc.prefill.inputs"):
            tok = np.zeros((bb, C), np.int32)
            tables = np.zeros((bb, pb), np.int32)
            qpos = np.full((bb, C), -1, np.int32)
            wpages = np.full((bb, pp), cache.scratch_block, np.int32)
            wstart = np.zeros((bb,), np.int32)
            wcount = np.zeros((bb,), np.int32)
            for j, i in enumerate(rows):
                blocks, _, cached = entries[i]
                tables[j, :len(blocks)] = blocks
                n = min(left[i], C)
                if n == 0:
                    continue
                p0 = cached + done[i]
                tok[j, :n] = suffix[i][done[i]:done[i] + n]
                qpos[j, :n] = p0 + np.arange(n)
                wpages[j], wstart[j] = cache.write_window(blocks, p0, n, pp)
                wcount[j] = n
        with trace.span("tc.prefill.launch"):
            h = step(tok, tables, qpos, wpages, wstart, wcount)
            for j, i in enumerate(rows):
                n = min(left[i], C)
                if 0 < n == left[i]:            # the suffix ends here
                    last_h[i] = h[j, n - 1].clone()
                done[i] += n


class TorchBackend:
    """Real compute: the model in PyTorch, real paged KV, real host offload.

    Each engine request maps to a row in a bucketed batch of block tables.
    One decode iteration is one ``models.model.paged_decode_step``: a loop
    over the stacked layers with the batched KV token-write kernel and the
    paged-attention kernel, no per-request Python in the write or attend
    path. Runs on ``device`` ("cuda" unless the caller asks for "cpu");
    ``params`` overrides the weights drawn from ``seed`` (the tests pass
    weights converted from the JAX backend). ``steps`` runs the decode
    step, the prefill chunk and the head: one CUDA graph per padded shape
    on the card (``StepGraphs``), eagerly on the CPU (``EagerSteps``).
    """

    def __init__(self, cfg, engine_cfg, platform, seed: int = 0,
                 device="cuda", params=None):
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
        self.steps = (G.StepGraphs(cfg, device) if device.type == "cuda"
                      else G.EagerSteps(cfg))
        # the batched paged prefill serves the archs whose layer body the
        # paged steps compute exactly (dense and MoE without a window);
        # every other arch prefills one request at a time
        self.batched_prefill = (cfg.arch_type in ("dense", "moe")
                                and cfg.sliding_window is None)
        # dense archs prefill in replays of up to PREFILL_TOKENS positions
        # of the rows left; MoE archs keep the JAX backend's lock step,
        # since an expert's capacity counts the replay's padded tokens, so
        # another shape would drop other entries
        self.prefill_budget = (PREFILL_TOKENS if cfg.arch_type == "dense"
                               else None)
        # batched prefill replays, the suffix tokens they computed and
        # their positions, padding included
        self.prefill_replays = self.prefill_tokens = self.prefill_slots = 0

    # -- engine hooks ----------------------------------------------------------
    def decode(self, reqs):
        reqs = [r for r in reqs if r.num_gpu_blocks > 0]
        if not reqs:
            return
        need = [r for r in reqs if self._needs_prefill(r)]
        if need:
            if self.batched_prefill:
                self._prefill_batch(need)
            else:
                for r in need:
                    self._prefill_one(r)
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
        computed and written (see ``paged_prefill_chunks``), in replays of
        up to ``PREFILL_TOKENS`` positions for dense archs and in the
        JAX backend's 32-token lock step for MoE archs."""
        bs = self.block_tokens
        for r in reqs:
            trace.stamp(r.rid, "prefill_start")
        with trace.span("tc.prefill", reqs=len(reqs)) as sp:
            items = [(r, *self._prefill_tokens(r)) for r in reqs]
            sp.set(tokens=sum(len(toks) - cached
                              for _, toks, cached in items))
            replays, slots = self.prefill_replays, self.prefill_slots
            last_h = paged_prefill_chunks(
                self._prefill_step, self.cache,
                [(r.gpu_blocks, toks, cached) for r, toks, cached in items],
                budget=self.prefill_budget)
            sp.set(replays=self.prefill_replays - replays,
                   slots=self.prefill_slots - slots)
            rows = [i for i, x in enumerate(last_h) if x is not None]
            if rows:
                # padded to the batch bucket, as the JAX backend does
                stack = [last_h[i] for i in rows]
                stack += [stack[0]] * (_bucket(len(items)) - len(rows))
                with trace.span("tc.prefill.head"):
                    logits = self.steps.head(self.params,
                                             torch.stack(stack))
                with trace.span("tc.prefill.readback"):
                    arr = logits[:len(rows)].float().cpu().numpy()
                for j, i in enumerate(rows):
                    self.last_prefill_logits[items[i][0].rid] = arr[j]
            for r, toks, _ in items:
                n_blocks = -(-len(toks) // bs) if toks else 0
                self._prefill_sig[r.rid] = tuple(r.gpu_blocks[:n_blocks])
                self.cache_len[r.rid] = len(toks)

    def _prefill_step(self, tokens, tables, q_pos, wpages, wstart, wcount):
        """One prefill replay of the batched prefill, counted."""
        self.prefill_replays += 1
        self.prefill_slots += tokens.size
        self.prefill_tokens += int(wcount.sum())
        return self.steps.prefill(self.params, self.cache.k, self.cache.v,
                                  tokens, tables, q_pos, wpages, wstart,
                                  wcount)

    def _prefill_one(self, req):
        """Dense-cache ``prefill`` of one request, its K/V written into the
        paged pool where the arch has one. As in the JAX backend,
        ``cache_len`` counts the text tokens only, and no prefill logits
        are kept."""
        trace.stamp(req.rid, "prefill_start")
        with trace.span("tc.prefill_one"):
            toks, _ = self._prefill_tokens(req)
            _, cache = M.prefill(self.cfg, self.params,
                                 self.prefill_batch(toks))
            if "k" in cache:
                # (L, 1, S, Hkv, D) -> the paged pool
                self.cache.write_prefill(req.gpu_blocks, cache["k"][:, 0],
                                         cache["v"][:, 0])
            n_blocks = -(-len(toks) // self.block_tokens)
            self._prefill_sig[req.rid] = tuple(req.gpu_blocks[:n_blocks])
            self.cache_len[req.rid] = len(toks)

    def prefill_batch(self, toks: List[int]) -> dict:
        """The dense-cache ``prefill`` batch of one request's tokens: zero
        patches ahead of a VLM's text, zero frames for an audio model."""
        cfg, dev = self.cfg, self.device
        batch = {"tokens": torch.tensor([toks], dtype=torch.int32,
                                        device=dev)}
        # the JAX backend's zeros are float32, which the model casts to its
        # own dtype: the same values as these
        dtype = M.torch_dtype(cfg)
        if cfg.arch_type == "vlm":
            batch["patches"] = torch.zeros(
                (1, cfg.num_patch_tokens, cfg.d_model), dtype=dtype,
                device=dev)
        if cfg.arch_type == "audio":
            batch["frames"] = torch.zeros(
                (1, cfg.encoder_frames, cfg.d_model), dtype=dtype,
                device=dev)
        return batch

    def _decode_batch(self, reqs):
        if self.cfg.arch_type in ("ssm", "audio"):
            return      # no paged decode state: no token, as in JAX
        with trace.span("tc.decode", rows=len(reqs),
                        bucket=_bucket(len(reqs))):
            with trace.span("tc.decode.inputs"):
                inputs, wrote = self.decode_inputs(reqs)
            with trace.span("tc.decode.launch"):
                logits = self.steps.decode(self.params, self.cache.k,
                                           self.cache.v, *inputs)
            # read before the next step: a replay overwrites ``logits``
            with trace.span("tc.decode.readback"):
                nxt = torch.argmax(logits[:len(reqs)], dim=-1).cpu().numpy()
            with trace.span("tc.decode.commit"):
                positions = inputs[2]
                for i, r in enumerate(reqs):
                    self.generated.setdefault(r.rid, []).append(int(nxt[i]))
                    if wrote[i]:
                        self.cache_len[r.rid] = int(positions[i]) + 1

    def decode_inputs(self, reqs):
        """The padded int32 inputs (numpy) of the decode step of ``reqs``
        (tokens, tables, positions, attn_lens, slots), and per request
        whether its new token's K/V has a slot."""
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
        return (toks, tables, positions, attn_lens, slots), wrote
