"""Checkpoint and restore of trees of tensors (``repro.train.checkpoint``).

The payload is the reference's: ``<dir>/step_<10 digits>/arrays.npz``
(leaf ``i`` under ``leaf_<i>``) and ``meta.json`` (step, treedef string,
``n_leaves``, sha256 of the payload), so a checkpoint written by either
package restores into the other.  Leaves are ordered as
``jax.tree.flatten`` orders them: dict keys sorted, lists, tuples and
NamedTuples (the port's ``AdamWState(step, mu, nu)``) in order, ``None``
an empty node; every other value is a leaf.

Fault tolerance:

  - atomic writes: the payload lands in ``<dir>/tmp.<uuid>`` and is then
    renamed, so a writer cut off mid-save never corrupts the latest
    checkpoint;
  - every checkpoint carries a content checksum, validated on restore;
  - ``latest_step`` scans for the newest *complete* checkpoint, skipping
    partial or corrupt ones;
  - rolling retention (``keep_n``) bounds disk usage.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import uuid
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, treedef string) in ``jax.tree.flatten``'s order and
    ``str(treedef)``'s notation."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            keys = sorted(x)
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}" for k in keys) + "}"
        if _is_namedtuple(x):
            kids = ", ".join(walk(v) for v in x)
            return f"CustomNode(namedtuple[{type(x).__name__}], [{kids}])"
        if isinstance(x, (list, tuple)):
            kids = [walk(v) for v in x]
            if isinstance(x, list):
                return "[" + ", ".join(kids) + "]"
            return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") \
                + ")"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            new = {k: build(x[k]) for k in sorted(x)}
            return {k: new[k] for k in x}
        if _is_namedtuple(x):
            return type(x)(*[build(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)

    return build(like)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step):010d}")


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep_n: int = 3) -> str:
    """Write ``tree`` as checkpoint ``step`` of ``ckpt_dir`` and keep the
    newest ``keep_n``.  Returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, treedef = _flatten(tree)
    arrays = {f"leaf_{i}": _as_numpy(x) for i, x in enumerate(leaves)}

    tmp = os.path.join(ckpt_dir, f"tmp.{uuid.uuid4().hex}")
    os.makedirs(tmp)
    payload = os.path.join(tmp, "arrays.npz")
    np.savez(payload, **arrays)
    del arrays
    meta = {"step": int(step), "treedef": treedef,
            "n_leaves": len(leaves), "sha256": _sha256(payload)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    # Rolling retention.
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_n]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return final


def all_steps(ckpt_dir: str) -> list:
    """The steps of ``ckpt_dir`` whose ``meta.json`` exists."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(name.split("_")[1]))
    return out


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest checkpoint that passes integrity validation."""
    for s in sorted(all_steps(ckpt_dir), reverse=True):
        path = _step_dir(ckpt_dir, s)
        try:
            meta = _read_meta(path)
            if _sha256(os.path.join(path, "arrays.npz")) == meta["sha256"]:
                return s
        except (OSError, ValueError, KeyError):
            continue
    return None


def restore_checkpoint(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree`` (shapes must match).  A
    leaf that is a tensor in ``like_tree`` comes back as a tensor of the
    payload's type on that leaf's device; any other leaf as a numpy
    array."""
    path = _step_dir(ckpt_dir, step)
    meta = _read_meta(path)
    payload = os.path.join(path, "arrays.npz")
    if _sha256(payload) != meta["sha256"]:
        raise IOError(f"checkpoint {path} failed checksum validation")
    leaves, _ = _flatten(like_tree)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"tree structure changed: {meta['n_leaves']} "
                         f"leaves saved, {len(leaves)} to restore")
    new_leaves = []
    with np.load(payload) as data:
        for i, old in enumerate(leaves):
            new = data[f"leaf_{i}"]
            if tuple(np.shape(old)) != tuple(new.shape):
                raise ValueError(f"shape mismatch {tuple(np.shape(old))} vs "
                                 f"{new.shape}")
            if isinstance(old, torch.Tensor):
                new = torch.from_numpy(new).to(old.device)
            new_leaves.append(new)
    return _unflatten(like_tree, new_leaves)
