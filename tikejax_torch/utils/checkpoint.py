"""Checkpoint / resume of reconstruction state.

Counterpart of ``tikejax.utils.checkpoint``, with the same file contract:
a nested dict of arrays (psi, prb, metrics, solver state) round-trips
through a single ``.npz`` file, keys joined with '/'; the containers are
dicts of dicts of arrays only (lists, tuples and non-dict roots raise
TypeError rather than being silently mangled); complex arrays are stored as
``<key>__re`` / ``<key>__im`` float pairs, so the files are readable by
plain numpy; the save is atomic (a temporary file, then ``os.replace``).
A file written by either package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_COMPLEX_SUFFIX_RE = "__re"
_COMPLEX_SUFFIX_IM = "__im"
_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            k = str(k)
            if _SEP in k:
                raise ValueError(f"checkpoint key may not contain '{_SEP}': "
                                 f"{k!r}")
            if k.endswith(_COMPLEX_SUFFIX_RE) or k.endswith(
                    _COMPLEX_SUFFIX_IM):
                raise ValueError(
                    f"checkpoint key may not end with the reserved "
                    f"complex-part suffixes '{_COMPLEX_SUFFIX_RE}'/"
                    f"'{_COMPLEX_SUFFIX_IM}': {k!r}")
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    if isinstance(tree, (list, tuple)):
        raise TypeError(
            "checkpoint containers must be nested dicts of arrays; got a "
            f"{type(tree).__name__} at {prefix or '<root>'!r} -- convert "
            "it to a dict (e.g. {'0': ..., '1': ...}) or stack it into "
            "one array")
    key = prefix[:-1] if prefix.endswith(_SEP) else prefix
    out[key] = tree
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree) -> None:
    """Save a nested dict of arrays (tensors on any device, numpy arrays or
    scalars) to ``path`` (.npz)."""
    if not isinstance(tree, dict):
        raise TypeError(
            "checkpoint root must be a dict of arrays, got "
            f"{type(tree).__name__}")
    arrays = {}
    for k, v in _flatten(tree).items():
        host = _to_numpy(v)
        if np.iscomplexobj(host):
            arrays[k + _COMPLEX_SUFFIX_RE] = host.real
            arrays[k + _COMPLEX_SUFFIX_IM] = host.imag
        else:
            arrays[k] = host
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def load(path: str, device: str | torch.device | None = None):
    """Load a checkpoint saved by :func:`save` (or by the JAX package's).

    Returns a nested dict of numpy arrays, or of tensors on ``device`` when
    one is given."""
    with np.load(path) as z:
        flat = {}
        for k in z.files:
            if k.endswith(_COMPLEX_SUFFIX_IM):
                continue
            if k.endswith(_COMPLEX_SUFFIX_RE):
                base = k[:-len(_COMPLEX_SUFFIX_RE)]
                flat[base] = z[k] + 1j * z[base + _COMPLEX_SUFFIX_IM]
            else:
                flat[k] = z[k]
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (torch.from_numpy(np.array(v)).to(device)
                           if device is not None else v)
    return tree
