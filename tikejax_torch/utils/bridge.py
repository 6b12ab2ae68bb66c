"""numpy <-> torch bridge for problem state shared with ``tikejax``.

The problem arrays (``psi``, ``scan``, ``prb``, ``data``) are built once in
numpy and handed to both packages, so tests compare the same inputs. The
bridge keeps the dtype (complex64 stays complex64, complex128 stays
complex128) and copies to the card unless the caller names another
device (the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from tikejax_torch.geometry import Geometry

_GEOMETRY_FIELDS = ("nz", "n", "nscan", "ndet", "nprb", "ntheta", "nmodes")


def to_torch(x, device: str | torch.device = "cuda") -> torch.Tensor:
    """Copy an array-like (numpy array, or anything ``np.asarray`` takes,
    such as a jax array) into a tensor on ``device`` with the same dtype."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a host numpy array with the same dtype."""
    return x.detach().cpu().numpy()


def to_numpy_tree(x):
    """``x`` with every tensor in it copied to a host numpy array: dicts,
    tuples and lists are rebuilt, any other leaf goes through
    ``np.asarray`` (a solver's metrics, carried state included, as the JAX
    package's facade returns them)."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    if isinstance(x, dict):
        return {k: to_numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy_tree(v) for v in x)
    return np.asarray(x)


def geometry_from(obj) -> Geometry:
    """This package's :class:`Geometry` from any object carrying the seven
    geometry fields (for example a ``tikejax.Geometry``)."""
    return Geometry(**{f: int(getattr(obj, f)) for f in _GEOMETRY_FIELDS})
