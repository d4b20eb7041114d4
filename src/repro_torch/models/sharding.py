"""Logical-axis sharding rules (MaxText-style), on DTensor.

The counterpart of ``repro.models.sharding``. Model code annotates
activations with *logical* axis names; the launch layer installs a mapping
from logical names to mesh axes. With no rules or no mesh installed (every
path but the dry-run: unit tests, serving, training on one card) every
annotation returns its argument, the very same object, so model code never
depends on a mesh.

A spec has one entry per tensor dimension, as ``PartitionSpec`` writes
them: None (replicated), a mesh axis name, or a tuple of axis names (the
dimension split over each, the first the major one). ``placements`` turns
a spec into the DTensor placements of a ``DeviceMesh``: a dimension on
("pod", "data") is ``Shard(d)`` on both mesh dimensions.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

_RULES: dict = {}
_MESH = None


def set_rules(mesh, rules: Optional[dict]):
    global _RULES, _MESH
    _RULES = dict(rules or {})
    _MESH = mesh


def get_rules():
    return _MESH, dict(_RULES)


@contextlib.contextmanager
def use_rules(mesh, rules):
    old = get_rules()
    set_rules(mesh, rules)
    try:
        yield
    finally:
        set_rules(*old)


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _parts(ax) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def spec(*names) -> tuple:
    """Translate logical axis names to a spec under the current rules."""
    return tuple(_RULES.get(n) if n is not None else None for n in names)


def placements(mesh, spec_: tuple) -> tuple:
    """The DTensor placements of ``spec_`` on ``mesh``: ``Shard(d)`` on
    each mesh dimension that tensor dimension ``d`` is split over,
    ``Replicate()`` on the others. Raises on an axis used twice, or on a
    dimension split over axes out of the mesh's order (which DTensor's
    placements cannot express)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec_):
        idx = [names.index(a) for a in _parts(ax)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec_}: dimension {d} splits over "
                             f"{ax}, out of the mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} used twice in "
                                 f"{spec_}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        """The per-device shape of a tensor of global ``shape``; every
        split dimension must divide by its axes, as the specs here give."""
        sizes = axis_sizes(self.mesh)
        out = []
        for d, ax in zip(shape, tuple(self.spec) + (None,) * len(shape)):
            n = 1
            for a in _parts(ax):
                n *= sizes[a]
            if d % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"divide over {ax} ({n} devices)")
            out.append(d // n)
        return tuple(out)


def logical(x, *names):
    """Constrain ``x``'s sharding by logical axis names: the port's
    ``with_sharding_constraint``. Without rules or a mesh, returns ``x``
    itself. Under rules it redistributes ``x`` (a DTensor, or a plain
    tensor, which every device holds whole) to the placements the names
    give, with the reference's rules: an axis is dropped from a dimension
    smaller than the axis, and where two dimensions map to one mesh axis
    the earlier dimension keeps it."""
    if _MESH is None or not _RULES:
        return x
    if len(names) != x.dim():
        raise ValueError(f"logical: {len(names)} names for a tensor of "
                         f"shape {tuple(x.shape)}")
    sizes = axis_sizes(_MESH)

    def fits(dim, ax):
        n = 1
        for a in _parts(ax):
            n *= sizes[a]
        return ax if dim >= n else None

    axes = [fits(d, _RULES.get(n) if n is not None else None)
            for d, n in zip(x.shape, names)]
    used: set = set()
    resolved = []
    for a in axes:
        parts = _parts(a)
        if any(p in used for p in parts):
            resolved.append(None)
        else:
            used.update(parts)
            resolved.append(a)
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, _MESH, [Replicate()] * _MESH.ndim,
                               run_check=False)
    return x.redistribute(_MESH, placements(_MESH, tuple(resolved)))


def named_sharding(*names) -> Optional[NamedSharding]:
    if _MESH is None:
        return None
    return NamedSharding(_MESH, spec(*names))
