"""Dump the JAX package's sharding specs and per-device argument bytes as
JSON, for the port's sharding and dry-run tests to hold their own to.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_spec_dump.py OUT.json

(the tests run it so, in a subprocess: the 512 placeholder devices must
be set before JAX is imported). For each production mesh ("16x16",
"2x16x16") and architecture: the ``param_spec_tree`` leaves by path,
``cache_shardings`` at each decode shape, ``batch_shardings`` at each
train / prefill shape, and, at every input shape, the per-device bytes of
the step's arguments as the dry-run's ``build_lowered`` places them
(parameters; the AdamW moments and step for train; the batch, or the
cache, tokens and ``cache_len``), summed from
``NamedSharding.shard_shape``. Specs are lists with one entry per
dimension: None, an axis name, or a list of axis names. Nothing is
compiled.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs.base import (ARCH_IDS, INPUT_SHAPES, config_for_shape,
                                get_config)
from repro.launch import sharding_rules as SR
from repro.launch import specs as SP
from repro.launch.mesh import make_production_mesh
from repro.models import model as M


def norm(spec, ndim):
    out = [list(a) if isinstance(a, tuple) else a for a in spec]
    return out + [None] * (ndim - len(out))


def path_of(path):
    return "/".join(str(k.key) for k in path)


def nbytes(shape, dtype, sharding):
    return math.prod(sharding.shard_shape(tuple(shape))) \
        * jnp.dtype(dtype).itemsize


def arg_bytes(cfg0, shape_name, mesh, pspecs, pshard):
    shp = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(cfg0, shp)
    ins = SP.input_specs(cfg0, shape_name)
    leaves = jax.tree.leaves(pspecs)
    shards = jax.tree.leaves(pshard)
    total = sum(nbytes(x.shape, x.dtype, s) for x, s in zip(leaves, shards))
    if shp.kind == "train":
        sd = jnp.bfloat16 if cfg.optimizer_state_dtype == "bfloat16" \
            else jnp.float32
        total += 2 * sum(nbytes(x.shape, sd, s)
                         for x, s in zip(leaves, shards))
        total += 4                                    # step, int32
    if shp.kind in ("train", "prefill"):
        bsh = SR.batch_shardings(cfg, mesh, ins["batch"])
        return total + sum(nbytes(v.shape, v.dtype, bsh[k])
                           for k, v in ins["batch"].items())
    kind = "long_decode" if shape_name == "long_500k" else "decode"
    csh = SR.cache_shardings(cfg, mesh, shp.global_batch, shp.seq_len, kind)
    total += sum(nbytes(v.shape, v.dtype, csh[k])
                 for k, v in ins["cache"].items())
    dp = ("pod", "data") if "pod" in mesh.axis_names else "data"
    tok_ax = dp if SR._divides(shp.global_batch, mesh, dp) else None
    total += nbytes(ins["tokens"].shape, jnp.int32,
                    NamedSharding(mesh, P(tok_ax)))
    return total + 4                                  # cache_len, int32


def dump():
    out = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        per_arch = {}
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            pspecs = M.param_specs(cfg)
            tree = SR.param_spec_tree(cfg, mesh)
            flat = jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]
            shapes = dict((path_of(p), x.shape) for p, x in
                          jax.tree_util.tree_flatten_with_path(pspecs)[0])
            rec = {"params": {path_of(p): norm(s, len(shapes[path_of(p)]))
                              for p, s in flat},
                   "cache": {}, "batch": {}, "arg_bytes": {}}
            pshard = SR.param_shardings(cfg, mesh)
            for shape_name, shp in INPUT_SHAPES.items():
                c = config_for_shape(cfg, shp)
                if shp.kind == "decode":
                    kind = "long_decode" if shape_name == "long_500k" \
                        else "decode"
                    specs = M.cache_specs(c, shp.global_batch, shp.seq_len)
                    rec["cache"][shape_name] = {
                        k: norm(ns.spec, len(specs[k].shape))
                        for k, ns in SR.cache_shardings(
                            c, mesh, shp.global_batch, shp.seq_len,
                            kind).items()}
                else:
                    batch = SP.input_specs(cfg, shape_name)["batch"]
                    rec["batch"][shape_name] = {
                        k: norm(ns.spec, len(batch[k].shape))
                        for k, ns in SR.batch_shardings(
                            c, mesh, batch).items()}
                rec["arg_bytes"][shape_name] = arg_bytes(
                    cfg, shape_name, mesh, pspecs, pshard)
            per_arch[arch] = rec
        out["2x16x16" if multi_pod else "16x16"] = per_arch
    return out


def run(out_dir) -> dict:
    """Run this script in a subprocess with 512 placeholder devices and
    return its dump (the tests' entry)."""
    root = Path(__file__).resolve().parents[1]
    out = Path(out_dir) / "jax_specs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    subprocess.run([sys.executable, __file__, str(out)], env=env,
                   check=True, timeout=300)
    return json.loads(out.read_text())


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump(dump(), f)
