"""Checkpoint / resume for engine state — counterpart of
``fft_convolution_tpu/utils/checkpoint.py``, without ``jax.tree``.

The reference's nearest analogue is ``Clone`` + ``reset()`` (state is a
plain value, SURVEY.md §5).  A port engine's ``snapshot()`` is a tree of
tuples, dicts, NamedTuples (``CrossfaderState``) and dataclasses
(``UniformState``, ``TwoStageState``, ``FDLState``, ``FusedState``,
``XfadeState``, ``StreamState``, ``Farm2State`` with its ``TailState``)
over tensors and host scalars.  :func:`save` walks it into one ``.npz``;
:func:`load` walks a template snapshot of the same engine and puts the
saved values back in its place.

* bf16 tensors (B1p's ring and table, B5p's) are stored as their raw
  16-bit view, with the dtype recorded, and viewed back on load; complex64
  tensors are stored as they are.
* Host ints, floats and bools come back as Python scalars, numpy scalars
  (the crossfader's float32 ramp) as numpy scalars of their dtype.
* A state's ``ticket`` (a one-launch kernel's arrival counter) is never
  saved: no two states share one, and a loaded state starts without one,
  as a clone does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NOT_SAVED = frozenset({"ticket"})
_HOST_SCALARS = {bool: "bool", int: "int", float: "float"}


def _children(node) -> list:
    """The sub-trees of a container node, in a fixed order."""
    if dataclasses.is_dataclass(node):
        return [getattr(node, f.name) for f in dataclasses.fields(node)
                if f.init and f.name not in _NOT_SAVED]
    if isinstance(node, (tuple, list)):
        return list(node)
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    raise TypeError(f"checkpoint: cannot walk a {type(node).__name__}")


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, np.generic, bool, int, float))


def _leaves(node, out: list) -> list:
    if node is None:
        return out
    if _is_leaf(node):
        out.append(node)
        return out
    for child in _children(node):
        _leaves(child, out)
    return out


def _kind(leaf) -> str:
    """What a leaf is, recorded beside its value: ``torch.<dtype>``,
    ``numpy.<dtype>``, ``ndarray.<dtype>``, or a host scalar type."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype)
    if isinstance(leaf, np.generic):
        return f"numpy.{leaf.dtype}"
    if isinstance(leaf, np.ndarray):
        return f"ndarray.{leaf.dtype}"
    return _HOST_SCALARS[type(leaf)]


def _encode(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, (torch.Tensor, np.ndarray)) else ()


def save(path: str, snapshot) -> None:
    """Persist an engine ``snapshot()`` to ``path`` (``.npz``)."""
    leaves = _leaves(snapshot, [])
    arrays = {f"leaf_{i}": _encode(leaf) for i, leaf in enumerate(leaves)}
    np.savez(path, kinds=np.array([_kind(leaf) for leaf in leaves], dtype=str), **arrays)


def _decode(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
        if like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(like.device)
    if isinstance(like, np.generic):
        return arr[()]
    if isinstance(like, np.ndarray):
        return arr
    return type(like)(arr)  # a host bool, int or float


def _rebuild(like, values):
    if like is None:
        return None
    if _is_leaf(like):
        return next(values)
    if dataclasses.is_dataclass(like):
        kw = {f.name: None if f.name in _NOT_SAVED else _rebuild(getattr(like, f.name), values)
              for f in dataclasses.fields(like) if f.init}
        return dataclasses.replace(like, **kw)
    if hasattr(like, "_fields"):  # NamedTuple
        return type(like)._make(_rebuild(c, values) for c in like)
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(c, values) for c in like)
    if isinstance(like, dict):
        rebuilt = {k: _rebuild(like[k], values) for k in sorted(like)}
        return {k: rebuilt[k] for k in like}
    raise TypeError(f"checkpoint: cannot rebuild a {type(like).__name__}")


def load(path: str, like):
    """Restore a snapshot saved by :func:`save`.  ``like`` is a template
    snapshot (e.g. ``engine.snapshot()`` of a fresh engine of the same
    configuration) giving the tree, and the device of each tensor; every
    leaf's shape and dtype are checked against it (``ValueError`` on a
    mismatch)."""
    like_leaves = _leaves(like, [])
    with np.load(path) as data:
        kinds = [str(k) for k in data["kinds"]]
        if len(kinds) != len(like_leaves):
            raise ValueError(f"checkpoint holds {len(kinds)} leaves, the template "
                             f"{len(like_leaves)}")
        values = []
        for i, (kind, leaf) in enumerate(zip(kinds, like_leaves)):
            arr = data[f"leaf_{i}"]
            if kind != _kind(leaf) or arr.shape != _shape(leaf):
                raise ValueError(f"checkpoint leaf {i}: expected {_shape(leaf)}/{_kind(leaf)}, "
                                 f"got {arr.shape}/{kind}")
            values.append(_decode(arr, leaf))
    return _rebuild(like, iter(values))
