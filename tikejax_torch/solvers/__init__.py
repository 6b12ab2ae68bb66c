"""Solvers: object-only Dai-Yuan conjugate-gradient reconstruction."""

from tikejax_torch.solvers.cg import CGOptions, run

__all__ = ["CGOptions", "run"]
