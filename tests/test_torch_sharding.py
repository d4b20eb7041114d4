"""The port's sharding layer against the JAX package's, without a compile.

The ports of ``test_sharding.py`` (param specs valid for every arch, cache
specs for ``decode_32k`` / ``long_500k``, ``logical``'s conflict rule), on
DTensor meshes over a fake process group: a 1 x 1 mesh as there, and the
production meshes. Then the specs themselves against JAX's: one
subprocess with 512 placeholder devices (``tests/jax_spec_dump.py``)
dumps the JAX ``param_spec_tree``, ``cache_shardings`` and
``batch_shardings`` for every arch at 16 x 16 and 2 x 16 x 16, and the
port's must equal them leaf for leaf.
"""
import pytest

torch = pytest.importorskip("torch")

import jax_spec_dump

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,
                                      config_for_shape, get_config)
from repro_torch.launch import sharding_rules as SR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import (NamedSharding, axis_sizes, logical,
                                         placements, use_rules)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def release_fake_group():
    """The fake process group the meshes stand over lives for this
    module only: other test files in the same worker find none."""
    yield
    import torch.distributed as dist
    from repro_torch.launch import mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh._MESHES.clear()


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    return jax_spec_dump.run(tmp_path_factory.mktemp("jax_specs"))


def mesh_of(name):
    return make_mesh(*MESHES[name])


def check_spec(spec, shape, mesh):
    """As ``test_sharding.check_spec``: known axes, each used once, every
    split dimension divisible; and the spec has DTensor placements."""
    sizes = axis_sizes(mesh)
    used = []
    assert len(spec) == len(shape), (spec, shape)
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            assert a in sizes, a
            assert a not in used, f"axis {a} used twice in {spec}"
            used.append(a)
            n *= sizes[a]
        assert dim % n == 0, (shape, spec)
    assert len(placements(mesh, spec)) == mesh.ndim


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_valid(arch, mesh_name):
    mesh = mesh_of(mesh_name)
    cfg = get_config(arch)
    specs = M.param_specs(cfg)
    tree = SR.param_spec_tree(cfg, mesh)
    assert tree.keys() == specs.keys()
    for path, (shape, _) in specs.items():
        check_spec(tree[path], shape, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_shardings_valid(arch, shape):
    for mesh_name in MESHES:
        mesh = mesh_of(mesh_name)
        shp = INPUT_SHAPES[shape]
        cfg = config_for_shape(get_config(arch), shp)
        kind = "long_decode" if shape == "long_500k" else "decode"
        shards = SR.cache_shardings(cfg, mesh, shp.global_batch, shp.seq_len,
                                    kind)
        specs = M.cache_specs(cfg, shp.global_batch, shp.seq_len)
        assert shards.keys() == specs.keys()
        for k, ns in shards.items():
            check_spec(ns.spec, specs[k][0], mesh)


def test_logical_conflict_resolution():
    """The second dim maps to axes the first took: it is dropped, not a
    crash; a dim smaller than its axis stays replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_mesh((2, 2), ("data", "model"))
    with use_rules(mesh, {"a": "data", "b": ("data", "model")}):
        y = logical(torch.zeros((4, 4)), "a", "b")
        assert isinstance(y, DTensor) and y.shape == (4, 4)
        assert y.placements == (Shard(0), Replicate())
        assert y.to_local().shape == (2, 4)
        z = logical(torch.zeros((1, 4)), "a", None)
        assert z.placements == (Replicate(), Replicate())
    with use_rules(mesh, {"b": ("data", "model")}):
        assert logical(torch.zeros((4, 4)), None, "b").placements == \
            (Shard(1), Shard(1))


def test_logical_without_rules_returns_the_same_object():
    x = torch.zeros((2, 3))
    assert logical(x, "batch", "embed") is x
    with use_rules(None, {"batch": "data"}):
        assert logical(x, "batch", "embed") is x
    with use_rules(make_mesh((1, 1), ("data", "model")), {}):
        assert logical(x, "batch", "embed") is x


def test_placements_refuse_a_reused_or_reordered_axis():
    mesh = make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="used twice"):
        placements(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="out of the mesh order"):
        placements(mesh, (("model", "data"),))
    with pytest.raises(ValueError, match="does not divide"):
        NamedSharding(mesh, ("data",)).shard_shape((3,))


def norm(spec, ndim):
    out = [list(a) if isinstance(a, tuple) else a for a in spec]
    return out + [None] * (ndim - len(out))


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, mesh_name, jax_dump):
    """param_spec_tree, cache_shardings and batch_shardings, leaf for
    leaf, equal to the JAX package's at the production meshes."""
    want = jax_dump[mesh_name][arch]
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
    cfg = get_config(arch)
    shapes = M.param_specs(cfg)
    got = {p: norm(s, len(shapes[p][0]))
           for p, s in SR.param_spec_tree(cfg, mesh).items()}
    assert got == want["params"]
    for shape_name, shp in INPUT_SHAPES.items():
        c = config_for_shape(cfg, shp)
        if shp.kind == "decode":
            kind = "long_decode" if shape_name == "long_500k" else "decode"
            shards = SR.cache_shardings(c, mesh, shp.global_batch,
                                        shp.seq_len, kind)
            specs = M.cache_specs(c, shp.global_batch, shp.seq_len)
            got = {k: norm(ns.spec, len(specs[k][0]))
                   for k, ns in shards.items()}
            assert got == want["cache"][shape_name], shape_name
        else:
            batch = SP.input_specs(cfg, shape_name)["batch"]
            got = {k: norm(ns.spec, batch[k].dim()) for k, ns in
                   SR.batch_shardings(c, mesh, batch).items()}
            assert got == want["batch"][shape_name], shape_name
