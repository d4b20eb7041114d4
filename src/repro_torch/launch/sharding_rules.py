"""Sharding rules: logical-axis tables + parameter/cache specs.

The counterpart of ``repro.launch.sharding_rules``, line for line, on a
DTensor ``DeviceMesh``. Specs are per-dimension tuples of mesh axes, as
``PartitionSpec`` writes them (``models.sharding``); a ``NamedSharding``
there turns one into DTensor placements.

Strategy (the reference's):
 * training   — FSDP x TP: stacked weights (L, in, out) shard in->data,
   out->model; experts shard E->data when divisible else cap->data;
   activations batch->(pod, data).
 * prefill    — batch->(pod,data), heads/ffn->model.
 * decode     — batch->(pod,data); KV cache batch->(pod,data).
 * long decode (batch=1) — context parallelism: cache seq->data.

Dimensions that do not divide their mesh axes are left replicated by
``logical`` (tiny dims) or split unevenly (large dims) — head counts of
20/25/36/40 fall back to hidden-dim sharding of the projection matrices.
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.sharding import NamedSharding, axis_sizes


def _none(nd: int) -> tuple:
    return (None,) * nd


def activation_rules(mesh, shape_kind: str) -> dict:
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    dp = dp if len(dp) > 1 else dp[0]
    rules = {
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "data",      # matches expert-weight FSDP axis (Kimi 384e)
        "expert_cap": dp,       # used when experts don't divide (Mixtral 8e)
    }
    if shape_kind == "long_decode":
        rules["batch"] = None
        rules["cache_seq"] = "data"
    else:
        rules["cache_seq"] = None
    return rules


def _divides(n: int, mesh, axis) -> bool:
    if axis is None:
        return False
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= axis_sizes(mesh)[a]
    return n % size == 0 and n >= size


def param_spec_tree(cfg, mesh, fsdp: bool = True) -> dict:
    """{"path/of/leaf": spec} matching ``M.param_specs(cfg)``."""
    specs = M.param_specs(cfg)
    # FSDP/ZeRO axis. The pod axis is folded in ONLY when params+optimizer
    # would overflow a chip's memory with in-pod sharding: the reference's
    # 14 GiB per-chip threshold, copied so that the specs stay equal (it
    # is a statement about the reference's TPU layout, not about the H100)
    opt_b = 4 if cfg.optimizer_state_dtype == "bfloat16" else 8
    per_chip = cfg.param_count() * (2 + opt_b) / 256
    data_ax = ("pod", "data") if ("pod" in mesh.mesh_dim_names
                                  and per_chip > 14 * 2**30) else "data"
    if cfg.replicate_params:
        # sub-HBM models (e.g. mamba2-130m): TP resharding collectives cost
        # more than the weights they save — replicate everything
        return {path: _none(len(shape)) for path, (shape, _) in specs.items()}

    def rule(path, shape):
        name = path.split("/")[-1]
        nd = len(shape)
        if name in ("embed",):
            if _divides(shape[0], mesh, "model"):
                return ("model", None)
            return (None, "model" if _divides(shape[1], mesh, "model")
                    else None)
        if name in ("unembed",):
            # vocab rarely divides 16 (e.g. 122753); shard d_model instead
            if _divides(shape[1], mesh, "model"):
                return (None, "model")
            return ("model" if _divides(shape[0], mesh, "model") else None,
                    None)
        if nd <= 2:
            return _none(nd)                         # norms, scalars, biases
        if name in ("we1", "we3", "we2"):            # (L, E, in, out)
            out_ax = "model" if _divides(shape[3], mesh, "model") else None
            if _divides(shape[1], mesh, data_ax):
                return (None, data_ax if fsdp else None, None, out_ax)
            in_ax = data_ax if (fsdp and _divides(shape[2], mesh, data_ax)) \
                else None
            return (None, None, in_ax, out_ax)
        if name == "wr":                             # router (L, d, E)
            return (None, None, None)
        if nd == 3:                                  # (L, in, out) matmuls
            in_ok = _divides(shape[1], mesh, data_ax)
            out_ok = _divides(shape[2], mesh, "model")
            return (None,
                    data_ax if (fsdp and in_ok) else None,
                    "model" if out_ok else None)
        return _none(nd)                             # conv (L, W, C) etc.

    return {path: rule(path, shape) for path, (shape, _) in specs.items()}


def param_shardings(cfg, mesh, fsdp: bool = True) -> dict:
    return {path: NamedSharding(mesh, s)
            for path, s in param_spec_tree(cfg, mesh, fsdp).items()}


def cache_shardings(cfg, mesh, batch: int, cache_size: int,
                    shape_kind: str) -> dict:
    specs = M.cache_specs(cfg, batch, cache_size)
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    long_ctx = shape_kind == "long_decode"

    def spec_for(name, shape):
        if name in ("k", "v", "cross_k", "cross_v"):
            # most assigned archs have kv_heads not divisible by 16
            # (GQA 2/5/8, MHA 20/36/40) — shard the cache sequence over
            # "model" instead (flash-decoding style partial softmax)
            kv_ax = "model" if _divides(shape[3], mesh, "model") else None
            seq_ax = None
            if kv_ax is None and _divides(shape[2], mesh, "model"):
                seq_ax = "model"
            if long_ctx and name in ("k", "v"):
                seq = ("data", "model") if (kv_ax is None and seq_ax) \
                    else "data"
                if not _divides(shape[2], mesh, seq):
                    seq = "data" if _divides(shape[2], mesh, "data") else None
                return (None, None, seq, kv_ax, None)
            batch_ax = dp if _divides(shape[1], mesh, dp) else None
            return (None, batch_ax, seq_ax, kv_ax, None)
        if name in ("k_scale", "v_scale"):        # (L, B, S, Hkv)
            kv_ax = "model" if _divides(shape[3], mesh, "model") else None
            seq_ax = "model" if (kv_ax is None
                                 and _divides(shape[2], mesh, "model")) \
                else None
            if long_ctx:
                return (None, None,
                        "data" if _divides(shape[2], mesh, "data") else None,
                        kv_ax)
            batch_ax = dp if _divides(shape[1], mesh, dp) else None
            return (None, batch_ax, seq_ax, kv_ax)
        if name == "conv":
            batch_ax = dp if _divides(shape[1], mesh, dp) else None
            return (None, batch_ax, None, None)
        if name == "state":
            # (L, B, H, P, N): heads rarely divide 16 (mamba2 H=24) — fall
            # back to sharding the value head_dim P (64/16 = 4) so the
            # recurrent state and its update compute still split on "model"
            h_ax = "model" if _divides(shape[2], mesh, "model") else None
            p_ax = "model" if (h_ax is None
                               and _divides(shape[3], mesh, "model")) else None
            batch_ax = dp if _divides(shape[1], mesh, dp) else None
            return (None, batch_ax, h_ax, p_ax, None)
        return _none(len(shape))

    return {k: NamedSharding(mesh, spec_for(k, shape))
            for k, (shape, _) in specs.items()}


def batch_shardings(cfg, mesh, batch_specs: dict) -> dict:
    """Shardings for a train/prefill input batch dict (tensors, or
    anything with a ``shape``)."""
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"

    def spec_for(name, shape):
        batch_ax = dp if _divides(shape[0], mesh, dp) else None
        return (batch_ax,) + _none(len(shape) - 1)

    return {k: NamedSharding(mesh, spec_for(k, v.shape))
            for k, v in batch_specs.items()}
