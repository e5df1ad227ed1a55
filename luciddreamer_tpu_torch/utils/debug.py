"""Failure detection: find non-finite values in a nested structure of
tensors and arrays, and dump it as an npz snapshot for offline inspection
(``Trainer.run`` does so on a non-finite loss when ``cfg.debug`` is set)."""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch


class NonFiniteError(RuntimeError):
    def __init__(self, bad: list[str], snapshot_path: str | None):
        self.bad_leaves = bad
        self.snapshot_path = snapshot_path
        msg = f"non-finite values in: {', '.join(bad)}"
        if snapshot_path:
            msg += f" (snapshot: {snapshot_path})"
        super().__init__(msg)


def _leaves(tree, path=""):
    """(path, numpy array) of every leaf, dict keys in sorted order; paths
    read like ``['a'][0]``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree.detach().cpu().numpy()
    elif tree is not None:
        yield path, np.asarray(tree)


def find_nonfinite(tree) -> list[str]:
    """Paths of the floating leaves that hold NaN or inf."""
    return [p for p, a in _leaves(tree)
            if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all()]


def snapshot(tree, outdir: str, tag: str = "snapshot") -> str:
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{tag}_{int(time.time())}.npz")
    np.savez_compressed(
        path,
        **{p.strip("[]'\"").replace("']['", "/"): a for p, a in _leaves(tree)},
    )
    return path


def check_finite(tree, outdir: str | None = None, tag: str = "snapshot"):
    """Raise NonFiniteError (with an npz dump if ``outdir``) when any
    floating leaf holds NaN or inf."""
    bad = find_nonfinite(tree)
    if bad:
        path = snapshot(tree, outdir, tag) if outdir else None
        raise NonFiniteError(bad, path)
