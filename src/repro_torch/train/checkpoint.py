"""Checkpoints of nested dicts of tensors and Python scalars.

The port's own format: ``torch.save`` of the tree with every tensor moved
to the host, written to a temporary file in the target's directory and
renamed over the target (``os.replace``), so a crash never leaves a
half-written checkpoint. ``load`` reads it back with ``weights_only``, so
a checkpoint cannot run code. (The JAX package pickles a JAX treedef
beside numpy leaves; the two formats are not interchangeable.)
"""
from __future__ import annotations

import os
import tempfile

import torch

from repro_torch.train.optimizer import tree_map


def _to_host(v):
    return v.detach().cpu() if isinstance(v, torch.Tensor) else v


def save(path: str, tree) -> None:
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(tree_map(_to_host, tree), f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str):
    """The tree ``save`` wrote, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
