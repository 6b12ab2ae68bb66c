"""Utilities: the numpy bridge and the CUDA kernel build helper."""

from tikejax_torch.utils.bridge import geometry_from, to_numpy, to_torch

__all__ = ["to_torch", "to_numpy", "geometry_from"]
