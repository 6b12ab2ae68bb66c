"""tikejax_torch -- the PyTorch/CUDA port of tikejax.

Far-field ptychography for one NVIDIA H100: the oracle diffraction
operators, the object-only conjugate-gradient solver (Dai-Yuan or L-BFGS)
with Gaussian and Poisson likelihoods, the split-operator deep-residual
solver ``reconstruct``, and the hand-written CUDA kernels ``grad_fused``,
``minf_fused`` and ``fwd`` that run their objective evaluations and
farplanes.
It imports ``torch`` and never ``jax``; ``tikejax`` stays the reference.
"""

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops.diffraction import Ptycho
from tikejax_torch.solvers import CGOptions, reconstruct, run

__version__ = "0.1.0"

__all__ = ["Geometry", "Ptycho", "CGOptions", "run", "reconstruct",
           "__version__"]
