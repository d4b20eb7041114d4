"""Multi-pod dry-run: run every (architecture x input shape) step on meta
tensors placed on the production mesh, and record per-device memory,
FLOPs and collective bytes.

The counterpart of ``repro.launch.dryrun``. Where the reference lowers
and compiles each step with XLA on 512 placeholder CPU devices, this one
runs the port's own step once on meta tensors (nothing is allocated or
computed): the parameters, optimizer state and inputs are DTensors placed
by the spec trees of ``sharding_rules`` on a fake 256- or 512-rank
``DeviceMesh`` (``launch.mesh``), under the activation rules
(``models.sharding.logical``) and inside DTensor's
``implicit_replication()`` (the plain tensors the model code makes
itself, RoPE tables and masks, count as replicated). The steps are the
reference's: the train step (loss, gradients with remat, AdamW), the
prefill, and one decode step against a cache of ``seq_len``.

    python -m repro_torch.launch.dryrun --arch glm4_9b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
    python -m repro_torch.launch.dryrun --all --perf-variant

Each record (``results/dryrun_torch/<arch>.<shape>.<mesh>.json``;
``--perf-variant`` writes ``results/dryrun_torch_perf/``, incremental:
existing files are skipped unless ``--force``) keeps the reference's keys
where they mean the same thing:

* ``status`` "ok" or "fail", with ``error`` and ``traceback``; a failure
  is recorded and the sweep goes on;
* ``memory.argument_bytes`` / ``output_bytes``: per-device bytes of the
  step's arguments and results, from the local shard of every DTensor
  (a plain tensor counts whole, as every device holds it);
* ``cost.flops``: per-device FLOPs, counted on the *local* computation
  DTensor runs on this rank (``torch.utils.flop_counter``'s formulas:
  matrix products, attention, convolutions), not on the global shapes;
* ``collectives``: per-device bytes of each collective's result, summed by
  kind ("all-gather", "reduce-scatter", "all-reduce", "all-to-all") plus
  ``total``, read from the functional collectives DTensor issues;
* ``cost_scan_corrected``: ``flops`` = cost(1) + (L - 1) (cost(2) -
  cost(1)) from the same step at 1 and 2 layers, and ``per_layer_flops``,
  as the reference extrapolates past XLA's once-counted scan body. The
  port's layers are a Python loop, so every layer is counted and this
  equals ``cost.flops`` wherever the 1- and 2-layer configs are sharded
  as the full one (not Kimi-K2 on 2 x 16 x 16: its small configs stay
  under the 14 GiB threshold that folds "pod" into the FSDP axis, as in
  the reference); unlike the reference it keeps the config's SSD chunk,
  since nothing here hides the chunk loop.

Keys without a counterpart are left out, not set to zero: XLA's
``temp_bytes``, ``alias_bytes`` and ``code_bytes`` (no buffer assignment
or code here), ``hlo_bytes`` and ``bytes accessed``. The figures are
counts for the reference's TPU layout, from DTensor's sharding
propagation, which picks its own collectives where GSPMD would pick
others; they are not measurements of any device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,
                                      config_for_shape, get_config)
from repro_torch.launch import sharding_rules as SR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import decoder as DEC
from repro_torch.models import model as M
from repro_torch.models.sharding import NamedSharding, use_rules
from repro_torch.train import optimizer as O
from repro_torch.train import train_loop as TL

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# functional collective (by the op's name, past its namespace) -> the
# reference's HLO kind
COLLECTIVE_KINDS = (("all_gather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_reduce", "all-reduce"),
                    ("all_to_all", "all-to-all"),
                    ("broadcast", "broadcast"))


def local_bytes(tree) -> int:
    """Per-device bytes of every tensor in ``tree`` (nested dicts, lists
    and tuples): a DTensor's local shard, a plain tensor whole."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def _counter():
    """A dispatch mode counting the local FLOPs and collective bytes of
    what runs under it (built on first use: torch.distributed loads
    then)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        """DTensor ops are let through (NotImplemented), so this mode
        sees the local ops and the collectives DTensor turns them into;
        ops on fake tensors are DTensor's own shape propagation on global
        shapes and are not counted."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.collectives = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if any(issubclass(t, FakeTensor) for t in types):
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if "c10d_functional" in func.namespace:
                name = packet.__name__
                for key, kind in COLLECTIVE_KINDS:
                    if name.startswith(key):
                        self.collectives[kind] = (
                            self.collectives.get(kind, 0) + local_bytes(out))
            return out

    return Counter()


class MalformedPlacements(RuntimeError):
    """A DTensor op returned a DTensor whose placements do not cover its
    mesh (PyTorch 2.11's ``aten.index.Tensor`` in MoE's combine, on a
    2-D mesh)."""


_REFUSALS = (RuntimeError, NotImplementedError, AssertionError, IndexError)


def _is_refusal(err: Exception) -> bool:
    """True for DTensor's refusal to run an op on the placements it was
    given: any error raised inside DTensor's dispatch of the op (no
    sharding rule; a view that would split a dimension unevenly, or one
    it plans wrongly, as unflattening a dimension split 512 ways on the
    2 x 16 x 16 mesh; an in-place op whose target is a plain tensor;
    PyTorch 2.11's plan for a pad along a sharded dimension), or an
    output whose placements do not cover the mesh. A genuine error still
    surfaces: it fails again once every argument is replicated."""
    if isinstance(err, MalformedPlacements):
        return True
    return any("distributed/tensor" in frame.filename
               for frame in traceback.extract_tb(err.__traceback__))


def _replicate_on_refusal():
    """A dispatch mode (entered after ``_counter``'s, so the counter sees
    what it runs) that runs an aten op DTensor refuses again with its
    DTensor arguments redistributed towards ``Replicate()``, one mesh
    dimension at a time from the innermost ("model") out, until DTensor
    accepts it (and returns DTensors whose placements cover the mesh): as
    GSPMD inserts a collective where a sharding does not fit, and keeps
    the other dimensions' split. Refused even when every
    argument is replicated (an in-place op on a plain tensor: MoE's
    per-expert counts), the op runs on the arguments' local values, which
    are then whole. Two ops are redistributed before they run: the
    sources of an in-place op to its target's placements (DTensor may
    otherwise change the target's placements and leave its local tensor
    as it was: ``index_copy_``), and a ``gather`` along a sharded
    dimension to that dimension replicated (DTensor's own rule leaves a
    masked partial sum, whose reduction fails on meta tensors: the
    loss's gold logits). The collectives are counted like any other. An
    in-place op run on copies writes its result back into its target at
    the target's own placements. ``replicated`` counts the ops so run,
    by name. It works below autograd, so the backward's ops (and remat's
    recomputation) go through it too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map

    # autograd has recorded the op being dispatched already, so the
    # redistributions below run on detached tensors and record nothing
    def gather_dim(i):
        def fn(t):
            if not isinstance(t, DTensor) or t.placements[i].is_replicate():
                return t
            pl = list(t.placements)
            pl[i] = Replicate()
            return t.detach().redistribute(t.device_mesh, pl)
        return fn

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def replicated(mesh):
        def fn(t):
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
            return t
        return fn

    def call(func, args, kwargs):
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, DTensor) and \
                    len(t.placements) != t.device_mesh.ndim:
                raise MalformedPlacements(f"{func} gave {t.placements} on a "
                                          f"{t.device_mesh.ndim}-D mesh")
        return out

    class ReplicateOnRefusal(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.replicated = {}

        def _count(self, name):
            self.replicated[name] = self.replicated.get(name, 0) + 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator) or \
                    not any(issubclass(t, DTensor) for t in types):
                return func(*args, **kwargs)
            name = func._overloadpacket.__name__
            target = args[0] if args else None
            inplace = name.endswith("_")
            if inplace and isinstance(target, DTensor):
                def to_target(t):
                    if isinstance(t, DTensor) and t is not target \
                            and t.dim() == target.dim() \
                            and t.placements != target.placements:
                        return t.detach().redistribute(
                            target.device_mesh, target.placements)
                    return t
                args = (target,) + tree_map(to_target, tuple(args[1:]))
            if name == "gather" and isinstance(target, DTensor):
                x, dim = target, args[1] % target.dim()
                for i, pl in enumerate(x.placements):
                    if pl == Shard(dim):
                        self._count(name)
                        x = gather_dim(i)(x)
                args = (x,) + tuple(args[1:])
            try:
                return call(func, args, kwargs)
            except _REFUSALS as e:
                if not _is_refusal(e):
                    raise
            self._count(name)
            mesh = next(t.device_mesh for t in tree_leaves((args, kwargs))
                        if isinstance(t, DTensor))
            r_args, r_kwargs = args, kwargs
            for i in reversed(range(mesh.ndim)):
                r_args, r_kwargs = tree_map(gather_dim(i), (r_args, r_kwargs))
                try:
                    out = call(func, r_args, r_kwargs)
                    break
                except _REFUSALS as e:
                    if not _is_refusal(e):
                        raise
            else:
                # a replicated DTensor's local tensor is its whole value,
                # so an in-place write there lands in r_args[0]; a new
                # result is every device's whole value: replicated
                out = func(*tree_map(local, r_args),
                           **tree_map(local, r_kwargs))
                if not (inplace and not isinstance(target, DTensor)):
                    out = tree_map(replicated(mesh), out)
            if inplace and isinstance(target, DTensor) \
                    and r_args[0] is not target:
                target.copy_(r_args[0].redistribute(
                    target.device_mesh, target.placements))
                return target
            return out

    return ReplicateOnRefusal()


def _place(t, ns: NamedSharding):
    """A meta DTensor of ``t``'s global shape and dtype, placed by
    ``ns``."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(ns.shard_shape(t.shape), dtype=t.dtype,
                        device="meta")
    stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(local, ns.mesh, ns.placements, run_check=False,
                              shape=t.shape, stride=stride)


def _replicated(mesh):
    return NamedSharding(mesh, ())


def _place_tree(tree, shardings, prefix=""):
    """``tree`` (a nested dict of meta tensors) with each leaf placed by
    ``shardings["path/of/leaf"]``."""
    return {k: _place_tree(v, shardings, f"{prefix}{k}/")
            if isinstance(v, dict) else _place(v, shardings[prefix + k])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# §Perf variants: per-pair options applied on top of the baseline config
# (the reference's PERF_VARIANTS, copied)
# ---------------------------------------------------------------------------

PERF_VARIANTS = {
    # memory-dominated MHA serving decode: int8 KV halves cache traffic
    ("qwen1_5_32b", "decode_32k"): {"kv_quant_int8": True},
    # trillion-param MoE training: save matmul outputs in remat (recompute
    # only elementwise ops) + drop MoE capacity factor 1.25 -> 1.0
    ("kimi_k2_1t_a32b", "train_4k"): {"remat_policy": "dots",
                                      "moe_capacity_factor": 1.0},
    # collective-bound tiny-SSM decode: weights fit any chip — replicate,
    # kill the TP resharding collectives entirely
    ("mamba2_130m", "decode_32k"): {"replicate_params": True},
    # skip the masked half of the prefill score matrix
    ("glm4_9b", "prefill_32k"): {"prefill_causal_skip": True},
}


def variant_config(arch: str, shape_name: str):
    kw = PERF_VARIANTS.get((arch, shape_name))
    if kw is None:
        return None
    return dataclasses.replace(get_config(arch), **kw)


def build_step(arch: str, shape_name: str, multi_pod: bool,
               cfg_override=None):
    """The placed arguments and the step of one pair: returns (step, args,
    mesh, rules, cfg), where ``step(*args)`` returns the step's results.
    Nothing runs yet."""
    base_cfg = cfg_override if cfg_override is not None else get_config(arch)
    shp = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(base_cfg, shp)
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = "long_decode" if shape_name == "long_500k" else shp.kind
    rules = SR.activation_rules(mesh, kind)
    in_specs = SP.input_specs(base_cfg, shape_name)

    pshard = SR.param_shardings(cfg, mesh)
    params = _place_tree(M.init_params(cfg, None, torch.device("meta")),
                         pshard)

    if shp.kind == "train":
        opt_cfg = O.AdamWConfig(state_dtype=cfg.optimizer_state_dtype)
        opt_state = O.init_opt_state(opt_cfg, params)
        opt_state["step"] = _place(opt_state["step"], _replicated(mesh))
        bshard = SR.batch_shardings(cfg, mesh, in_specs["batch"])
        batch = {k: _place(v, bshard[k]) for k, v in in_specs["batch"].items()}
        train_step = TL.make_train_step(cfg, opt_cfg)
        return train_step, (params, opt_state, batch), mesh, rules, cfg

    if shp.kind == "prefill":
        bshard = SR.batch_shardings(cfg, mesh, in_specs["batch"])
        batch = {k: _place(v, bshard[k]) for k, v in in_specs["batch"].items()}

        def prefill_step(params, batch):
            return M.prefill(cfg, params, batch)

        return prefill_step, (params, batch), mesh, rules, cfg

    # decode: one token against a cache of seq_len
    cshard = SR.cache_shardings(cfg, mesh, shp.global_batch, shp.seq_len,
                                kind)
    cache = {k: _place(v, cshard[k]) for k, v in in_specs["cache"].items()}
    dp = ("pod", "data") if multi_pod else "data"
    tok_ax = dp if SR._divides(shp.global_batch, mesh, dp) else None
    tokens = _place(in_specs["tokens"], NamedSharding(mesh, (tok_ax,)))
    cache_len = _place(in_specs["cache_len"], _replicated(mesh))

    def serve_step(params, cache, tokens, cache_len):
        # the port's decode_step takes the position as a Python int; the
        # last slot of the cache, counted as the reference's int32 argument
        del cache_len
        return M.decode_step(cfg, params, cache, tokens, shp.seq_len - 1)

    return serve_step, (params, cache, tokens, cache_len), mesh, rules, cfg


def run_step(arch: str, shape_name: str, multi_pod: bool,
             cfg_override=None) -> dict:
    """Run one pair's step under the counter. Returns {"argument_bytes",
    "output_bytes", "flops", "collectives", "cfg"}."""
    from torch.distributed.tensor.experimental import implicit_replication
    step, args, mesh, rules, cfg = build_step(arch, shape_name, multi_pod,
                                              cfg_override)
    arg_bytes = local_bytes(args)
    counter, refusals = _counter(), _replicate_on_refusal()
    DEC.set_remat(INPUT_SHAPES[shape_name].kind == "train")
    try:
        with use_rules(mesh, rules), implicit_replication(), counter, \
                refusals:
            out = step(*args)
    finally:
        DEC.set_remat(False)
    coll = dict(counter.collectives)
    coll["total"] = sum(coll.values())
    return {"argument_bytes": arg_bytes, "output_bytes": local_bytes(out),
            "flops": float(counter.flops), "collectives": coll,
            "replicated_ops": refusals.replicated, "cfg": cfg}


def extrapolated_cost(arch: str, shape_name: str, multi_pod: bool,
                      cfg_override=None) -> dict:
    """FLOPs at full depth from the same step at 1 and 2 layers:
    cost(L) = cost(1) + (L - 1) * (cost(2) - cost(1))."""
    base = cfg_override if cfg_override is not None else get_config(arch)
    costs = []
    for n in (1, 2):
        small = dataclasses.replace(
            base, num_layers=n, encoder_layers=min(base.encoder_layers, n))
        costs.append(run_step(arch, shape_name, multi_pod, small)["flops"])
    per_layer = costs[1] - costs[0]
    return {"flops": costs[0] + (base.num_layers - 1) * per_layer,
            "per_layer_flops": per_layer}


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            force: bool = False, cfg_override=None) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}.{shape_name}.{mesh_name}"
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok"}
    t0 = time.time()
    try:
        got = run_step(arch, shape_name, multi_pod, cfg_override)
        rec["step_s"] = round(time.time() - t0, 1)
        rec["memory"] = {"argument_bytes": got["argument_bytes"],
                         "output_bytes": got["output_bytes"]}
        rec["cost"] = {"flops": got["flops"]}
        rec["collectives"] = got["collectives"]
        rec["replicated_ops"] = got["replicated_ops"]
        try:
            rec["cost_scan_corrected"] = extrapolated_cost(
                arch, shape_name, multi_pod, cfg_override=cfg_override)
        except Exception as e:  # noqa: BLE001
            rec["cost_scan_corrected"] = {"error": str(e)[:300]}
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)

    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {tag}: {rec['status']} ({rec['total_s']}s)", flush=True)
    if rec["status"] == "ok":
        gb = rec["memory"]["argument_bytes"] / 2**30
        print(f"         args/device {gb:.2f} GiB, "
              f"flops {rec['cost']['flops']:.3e}, "
              f"coll {rec['collectives']['total'] / 2**30:.3f} GiB",
              flush=True)
    else:
        print("         " + rec["error"][:200], flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--recost", action="store_true",
                    help="only refresh cost_scan_corrected in existing JSONs")
    ap.add_argument("--perf-variant", action="store_true",
                    help="apply PERF_VARIANTS overrides; write to "
                         "results/dryrun_torch_perf/")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    pairs = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    n_ok = 0
    for a, s, mp in pairs:
        if args.recost:
            mesh_name = "2x16x16" if mp else "16x16"
            path = os.path.join(args.out, f"{a}.{s}.{mesh_name}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                rec = json.load(f)
            if rec.get("status") != "ok":
                continue
            try:
                rec["cost_scan_corrected"] = extrapolated_cost(a, s, mp)
                n_ok += 1
            except Exception as e:  # noqa: BLE001
                rec["cost_scan_corrected"] = {"error": str(e)[:300]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[recost] {a}.{s}.{mesh_name}: "
                  f"{rec['cost_scan_corrected'].get('flops', 'ERR')}",
                  flush=True)
            continue
        override = None
        out_dir = args.out
        if args.perf_variant:
            override = variant_config(a, s)
            if override is None:
                continue
            out_dir = os.path.join(os.path.dirname(args.out.rstrip("/")),
                                   "dryrun_torch_perf")
        rec = run_one(a, s, mp, out_dir, force=args.force,
                      cfg_override=override)
        n_ok += rec["status"] == "ok"
    print(f"[dryrun] {n_ok}/{len(pairs)} ok")
    return n_ok, len(pairs)


if __name__ == "__main__":
    main()
