"""tikejax_torch -- the PyTorch/CUDA port of tikejax.

Far-field ptychography for one NVIDIA H100: the oracle diffraction
operators, the object-only Dai-Yuan conjugate-gradient solver with
Gaussian and Poisson likelihoods, and the hand-written ``grad_fused`` CUDA
kernel that runs every objective evaluation of the solver's main path.
It imports ``torch`` and never ``jax``; ``tikejax`` stays the reference.
"""

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops.diffraction import Ptycho
from tikejax_torch.solvers import CGOptions, run

__version__ = "0.1.0"

__all__ = ["Geometry", "Ptycho", "CGOptions", "run", "__version__"]
