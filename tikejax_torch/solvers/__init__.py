"""Solvers: conjugate-gradient reconstruction of the object, or of the
object and the probe (Dai-Yuan or L-BFGS directions), and the
deep-residual solver ``reconstruct``."""

from tikejax_torch.solvers.cg import CGOptions, run
from tikejax_torch.solvers.tiered import reconstruct

__all__ = ["CGOptions", "run", "reconstruct"]
