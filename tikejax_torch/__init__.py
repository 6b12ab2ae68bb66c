"""tikejax_torch -- the PyTorch/CUDA port of tikejax.

Far-field ptychography for one NVIDIA H100: the diffraction operators on
three tiers (the ``'xla'`` oracle, the hybrid ``'pallas'`` tier with cuFFT
between hand-written patch kernels, and the ``'fused*'`` tiers with the DFT
inside the kernels), the conjugate-gradient solver (Dai-Yuan or L-BFGS; the
object, or the object and the probe; position streaming; both memory modes)
with Gaussian and Poisson likelihoods, the split-operator deep-residual
solver ``reconstruct`` with its joint probe chains, and the
reference-shaped facade ``tikejax_torch.compat.CGPtychoSolver`` (numpy in,
numpy out). Twelve hand-written CUDA kernels run the objective
evaluations, gradients, farplanes, adjoints and line searches:
``grad_fused``, ``minf_fused``, ``fwd``, ``grad_prb_fused``, ``adj``,
``adj_probe``, ``adj_residual`` and ``fwd_quad_stats`` (``ops.fused``),
``ls_objectives`` (``ops.linesearch``), and ``gather_probe_mul``,
``scatter_conj_probe`` and ``adj_probe_reduce`` (``ops.kernels``).
``tikejax_torch.parallel`` shards the positions and the angles over gloo
ranks (``run_sharded``, ``reconstruct(mesh=)``, the facade's ``mesh=``)
and tiles the object's rows with a halo exchange (``run_tiled``).
It imports ``torch`` and never ``jax``; ``tikejax`` stays the reference.
"""

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops.diffraction import Ptycho
from tikejax_torch.solvers import CGOptions, reconstruct, run

__version__ = "0.1.0"

__all__ = ["Geometry", "Ptycho", "CGOptions", "run", "reconstruct",
           "__version__"]
