"""Checkpoint / resume (port of ``positionbaseddynamics_tpu/utils/
checkpoint.py``): a :class:`SimState` to an npz of its leaves and back.

The file holds ``leaf_0 … leaf_{n-1}`` in the order ``jax.tree.flatten``
gives JAX's ``SimState``: the dataclass fields in declaration order,
recursing into the particle, orientation and rigid parts, ``None`` fields
skipped. The two packages' states have the same fields in the same order,
so a checkpoint written by either loads into the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaves(obj) -> list:
    """The tensors of a dataclass tree in field order, ``None`` skipped."""
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            out.extend(_leaves(getattr(obj, f.name)))
        return out
    return [obj]


def _rebuild(obj, leaves):
    """``obj`` with its tensors replaced, in field order, from the
    iterator ``leaves``."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), leaves)
            for f in dataclasses.fields(obj)})
    return next(leaves)


def save_state(path: str, state) -> None:
    """Serialize a :class:`SimState` (or any dataclass tree of tensors) to
    npz."""
    arrays = {f"leaf_{i}": t.detach().cpu().numpy()
              for i, t in enumerate(_leaves(state))}
    np.savez(path, **arrays)


def load_state(path: str, template):
    """Restore a state saved by :func:`save_state` (or by the JAX
    package's). ``template`` gives the structure, e.g. the freshly built
    state; each leaf lands on its template leaf's device."""
    with np.load(path) as z:
        leaves = [torch.from_numpy(np.array(z[f"leaf_{i}"])).to(t.device)
                  for i, t in enumerate(_leaves(template))]
    return _rebuild(template, iter(leaves))
