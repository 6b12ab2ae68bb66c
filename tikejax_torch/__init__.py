"""tikejax_torch -- the PyTorch/CUDA port of tikejax.

Far-field ptychography for one NVIDIA H100: the oracle diffraction
operators, the conjugate-gradient solver (Dai-Yuan or L-BFGS; the object,
or the object and the probe; position streaming) with Gaussian and Poisson
likelihoods, the split-operator deep-residual solver ``reconstruct`` with
its joint probe chains, and the hand-written CUDA kernels ``grad_fused``,
``minf_fused``, ``fwd``, ``grad_prb_fused``, ``adj`` and ``adj_probe`` that
run their objective evaluations, gradients, farplanes and adjoints.
It imports ``torch`` and never ``jax``; ``tikejax`` stays the reference.
"""

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops.diffraction import Ptycho
from tikejax_torch.solvers import CGOptions, reconstruct, run

__version__ = "0.1.0"

__all__ = ["Geometry", "Ptycho", "CGOptions", "run", "reconstruct",
           "__version__"]
