"""The serving steps compiled per bucket: one CUDA graph for each shape
the backend pads a step to.

The counterpart of the JAX package's jitted ``paged_decode_step``,
``paged_prefill_step`` and ``head_logits`` (``repro.models.model``),
which compile one program per (config, batch bucket, table bucket)
shape. Here the first call of a bucket runs the step once eagerly on a
side stream, then captures it into a ``torch.cuda.CUDAGraph``; that call
and every later one of the bucket copy their inputs into the graph's
static buffers and replay it: one graph launch and one input copy in
place of the ~2,000 kernel launches of the 48-layer eager loop. The
kernels are the same, so a replay computes what the eager step computes.

Bucket keys, read off the padded inputs (``core.backend._bucket``):

    decode   (bb, pb)          tokens (bb,), tables (bb, pb)
    prefill  (bb, C, pb, pp)   tokens (bb, C), tables (bb, pb),
                               wpages (bb, pp)
    head     (bb,)             hidden rows (bb, d)

The params and the K/V pools are captured by address: every replay
checks that it is given the very tensors its graph captured (the cache
allocates its pools once and writes them in place). A replay overwrites
the graph's static output, so a caller reads or copies what it needs
before its next call of the same bucket.

``EagerSteps`` is the same interface run eagerly: the CPU path, where
CUDA graphs do not exist. On the card ``StepGraphs`` never falls back to
it: a capture that fails raises, naming the bucket.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.models import model as M

KINDS = ("decode", "prefill", "head")
# int32 elements between the starts of two packed inputs (256 bytes)
_ALIGN = 64


def bucket_key(kind: str, inputs) -> tuple:
    """The bucket of a step call, from the shapes of its padded inputs
    (in the order of ``StepGraphs``' methods)."""
    if kind == "decode":
        return tuple(inputs[1].shape)                     # tables (bb, pb)
    if kind == "prefill":
        tok, tables, _, wpages = inputs[:4]
        return (*tok.shape, tables.shape[1], wpages.shape[1])
    if kind == "head":
        return (inputs[0].shape[0],)
    raise ValueError(f"unknown step kind {kind!r}")


def _step(cfg, kind, params, pools, inputs):
    if kind == "decode":
        return M.paged_decode_step(cfg, params, *pools, *inputs)
    if kind == "prefill":
        return M.paged_prefill_step(cfg, params, *pools, *inputs)
    return M.head_logits(cfg, params, *inputs)


def _leaves(tree) -> tuple:
    if isinstance(tree, dict):
        return tuple(x for v in tree.values() for x in _leaves(v))
    return (tree,)


class EagerSteps:
    """The three steps run eagerly, their int32 inputs given as numpy
    arrays: the path on the CPU."""

    def __init__(self, cfg):
        self.cfg = cfg

    def decode(self, params, k_pool, v_pool, tokens, tables, positions,
               attn_lens, slots):
        """``models.model.paged_decode_step``; returns logits (bb, V)."""
        return self._run("decode", params, (k_pool, v_pool), (
            tokens, tables, positions, attn_lens, slots))

    def prefill(self, params, k_pool, v_pool, tokens, tables, q_pos, wpages,
                wstart, wcount):
        """``models.model.paged_prefill_step``; returns hidden
        (bb, C, d)."""
        return self._run("prefill", params, (k_pool, v_pool), (
            tokens, tables, q_pos, wpages, wstart, wcount))

    def head(self, params, h):
        """``models.model.head_logits`` of hidden rows h (bb, d)."""
        return M.head_logits(self.cfg, params, h)

    def _run(self, kind, params, pools, arrays):
        dev = pools[0].device
        return _step(self.cfg, kind, params, pools,
                     [torch.from_numpy(a).to(dev) for a in arrays])


class _Graph:
    """One captured bucket: the graph, its static inputs (and, for numpy
    inputs, the pinned host buffer they are staged through), its static
    output, the tensors it captured by address, and the kernel launches
    of one replay."""

    def __init__(self):
        self.graph = None
        self.inputs = ()
        self.out = None
        self.host = self.dev = None      # packed int32 staging
        self.host_views = ()
        self.copied = None               # event: staging copy issued
        self.bound = ()
        self.launches: Dict[str, int] = {}


class StepGraphs:
    """The steps of ``EagerSteps``, each bucket captured once into a CUDA
    graph on ``device`` and replayed.

    ``captures[kind]`` counts the buckets captured (each capture runs the
    step once eagerly first), ``replays[kind]`` the replays, and
    ``capture_s`` the seconds spent capturing. Each replay adds the
    kernel launches its capture recorded to ``ops.launches``.

    Memory: each graph gets its own private memory pool (the default of
    ``torch.cuda.graph``). PyTorch allows graphs to share a pool only if
    they are replayed in the order they were captured; the engine
    replays decode, prefill and head buckets in whatever order its
    batches come, and a shared pool would let one graph's temporaries
    land on another graph's static output. Each graph's pool holds one
    step's peak of temporaries.
    """

    def __init__(self, cfg, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"StepGraphs: CUDA graphs need a CUDA device, "
                             f"got {device}; the CPU path is EagerSteps")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.device = device
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = dict.fromkeys(KINDS, 0)
        self.replays = dict.fromkeys(KINDS, 0)
        self.capture_s = 0.0
        self._stream = None              # warm-up and capture stream

    def decode(self, params, k_pool, v_pool, tokens, tables, positions,
               attn_lens, slots):
        """Replay of ``paged_decode_step``; returns the graph's static
        logits (bb, V)."""
        return self._call("decode", params, (k_pool, v_pool), (
            tokens, tables, positions, attn_lens, slots))

    def prefill(self, params, k_pool, v_pool, tokens, tables, q_pos, wpages,
                wstart, wcount):
        """Replay of ``paged_prefill_step``; returns the graph's static
        hidden (bb, C, d)."""
        return self._call("prefill", params, (k_pool, v_pool), (
            tokens, tables, q_pos, wpages, wstart, wcount))

    def head(self, params, h):
        """Replay of ``head_logits`` of the device rows h (bb, d); returns
        the graph's static logits (bb, V)."""
        return self._call("head", params, (), (h,))

    # ------------------------------------------------------------------
    def _call(self, kind, params, pools, inputs):
        key = (kind, *bucket_key(kind, inputs))
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(key, params, pools, inputs)
        else:
            bound = (*pools, *_leaves(params))
            if len(bound) != len(g.bound) or any(
                    a is not b for a, b in zip(bound, g.bound)):
                raise RuntimeError(
                    f"{kind} bucket {key[1:]}: the params or KV pools are "
                    "not the tensors its CUDA graph captured")
            self._load(g, inputs)
        g.graph.replay()
        ops.add_launches(g.launches)
        self.replays[kind] += 1
        return g.out

    def _load(self, g, inputs):
        """Copy a call's inputs into the graph's static inputs: device rows
        directly, numpy arrays through the pinned host buffer in one copy
        (after the previous copy out of that buffer has landed: the
        host's wait is the tracer's ``tc.graph.wait``)."""
        if g.host is None:
            g.inputs[0].copy_(inputs[0])
            return
        with trace.span("tc.graph.wait"):
            g.copied.synchronize()
        for view, a in zip(g.host_views, inputs):
            np.copyto(view, a, casting="safe")
        g.dev.copy_(g.host, non_blocking=True)
        g.copied.record()

    def _static_inputs(self, g, inputs):
        if isinstance(inputs[0], torch.Tensor):          # head: device rows
            g.inputs = (torch.empty_like(inputs[0]),)
            return
        offs, n = [], 0
        for a in inputs:
            offs.append(n)
            n += -(-a.size // _ALIGN) * _ALIGN
        g.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        g.dev = torch.empty(n, dtype=torch.int32, device=self.device)
        hnp = g.host.numpy()
        g.host_views = tuple(hnp[o:o + a.size].reshape(a.shape)
                             for o, a in zip(offs, inputs))
        g.inputs = tuple(g.dev[o:o + a.size].view(a.shape)
                         for o, a in zip(offs, inputs))
        g.copied = torch.cuda.Event()

    def _capture(self, key, params, pools, inputs) -> _Graph:
        """Warm up and capture bucket ``key``; its static inputs hold this
        call's inputs when it returns."""
        kind = key[0]
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        g = _Graph()
        self._static_inputs(g, inputs)
        self._load(g, inputs)
        g.bound = (*pools, *_leaves(params))
        cur = torch.cuda.current_stream(self.device)
        # one eager run loads the kernel libraries and fills the wrappers'
        # caches (RoPE table, split counts) and the libraries' per-stream
        # state outside the capture (PyTorch's CUDA-graph recipe); it
        # computes what the replay computes: a step rewrites the pool
        # slots it reads from the same inputs
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            _step(self.cfg, kind, params, pools, g.inputs)
        cur.wait_stream(self._stream)
        g.graph = torch.cuda.CUDAGraph()
        counts: Dict[str, int] = {}
        try:
            with ops.capture_launches() as counts, \
                    torch.cuda.graph(g.graph, stream=self._stream):
                g.out = _step(self.cfg, kind, params, pools, g.inputs)
        except (RuntimeError, ValueError, TypeError) as e:
            done = {k: n for k, n in counts.items() if n}
            raise RuntimeError(
                f"CUDA graph capture of the {kind} step failed for bucket "
                f"{key[1:]} (launches captured before the failure: "
                f"{done}): {e}") from e
        g.launches = {k: n for k, n in counts.items() if n}
        self.graphs[key] = g
        self.captures[kind] += 1
        self.capture_s += time.perf_counter() - t0
        return g
