"""Fused multi-candidate line-search objective: the hand-written
``ls_objectives`` kernel.

Counterpart of ``tikejax.ops.pallas_linesearch``. The CG line search needs
``minf(psi + gamma_k d)`` for a backtracking sequence of K steps. By
linearity of the forward model the per-pixel intensity at step gamma is the
quadratic ``a + 2 gamma b + gamma^2 c`` in three statistics of the two
farplanes ``G psi`` and ``G d``; ``ls_objectives`` (replaces
``pallas_linesearch.py`` ``ls_objectives``, ``_ls_kernel``) reads both
farplanes and the data ONCE and returns the objective at all K steps, so
the whole search costs one pass over memory however many halvings it takes.

Its formulas are the TPU kernel's, which differ from the solver's other
objectives in two ways the callers must know: the Gaussian term has no
epsilon (``sqrt(I)``, not ``sqrt(I + 1e-12)``), and no position is masked
(a masked dummy's zero frames add its data term at every step).

The CUDA source is ``tikejax_torch/csrc/ls_objectives.cu``; see its note
for what bounds it on an H100. Its kernel is frame-major: a block walks
whole frames, each thread sums its pixels of a frame in float and the
frame's sums go into the block's double partials in a fixed order; it is
templated on the step bucket :func:`step_bucket`. The partials are summed
over blocks in a fixed order: bitwise reproducible. On a CUDA tensor the
function launches the kernel or raises; on a CPU tensor it runs
:func:`ls_objectives_reference`. Each keeps an integer count of its runs in
its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from tikejax_torch.models import likelihoods
from tikejax_torch.ops import _launch

# The kernel keeps one accumulator per step in registers.
MAX_STEPS = 33
# The kernel's instantiations: the number of accumulators.
STEP_BUCKETS = (1, 2, 4, 8, 17, 33)


def step_bucket(k: int) -> int:
    """The kernel's step bucket for ``k`` steps: the smallest
    of :data:`STEP_BUCKETS` that is ``>= k`` (its steps past ``k`` are
    skipped by a uniform guard); ``k`` outside 1..33 raises."""
    if not 1 <= k <= MAX_STEPS:
        raise ValueError(f"ls_objectives: needs 1 to {MAX_STEPS} steps, got "
                         f"{k}")
    return next(b for b in STEP_BUCKETS if b >= k)


def ls_objectives(fpsi: torch.Tensor, fd: torch.Tensor, data: torch.Tensor,
                  gammas, model: str) -> torch.Tensor:
    """Objective values at all candidate steps in one pass.

    Args:
      fpsi, fd: ``(ntheta, nscan, nmodes, nd, nd)`` complex farplanes of
        the current iterate and of the search direction.
      data: ``(ntheta, nscan, nd, nd)`` measured intensities.
      gammas: the K candidate steps (1 <= K <= 33), taken as float32 as the
        JAX package takes them.
      model: 'gaussian' or 'poisson'.

    Returns:
      ``(K,)`` real objective values.
    """
    _launch.check_model(model)
    gammas = torch.as_tensor(gammas, dtype=torch.float32, device=fpsi.device)
    if not _launch.route("ls_objectives", fpsi):
        return ls_objectives_reference(fpsi, fd, data, gammas, model)
    return _ls_objectives_cuda(fpsi, fd, data, gammas, model)


ls_objectives.launches = 0


def ls_objectives_reference(fpsi: torch.Tensor, fd: torch.Tensor,
                            data: torch.Tensor, gammas,
                            model: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`ls_objectives`: the statistics, then
    the K objectives over whole arrays, with the TPU kernel's formulas."""
    ls_objectives_reference.launches += 1
    a = likelihoods.total_intensity(fpsi)
    b = torch.sum((torch.conj(fpsi) * fd).real, dim=2)
    c = likelihoods.total_intensity(fd)
    d = torch.clamp_min(data, 0.0)
    values = []
    for g in torch.as_tensor(gammas, dtype=torch.float32).tolist():
        inten = torch.clamp_min(a + 2.0 * g * b + g * g * c, 0.0)
        if model == "gaussian":
            values.append(torch.sum((torch.sqrt(inten) - torch.sqrt(d))**2))
        else:
            values.append(torch.sum(inten - d * torch.log(inten + 1e-8)))
    return torch.stack(values)


ls_objectives_reference.launches = 0


def _ls_objectives_cuda(fpsi, fd, data, gammas, model):
    """Launches ``ls_objectives``' kernel and its block sum."""
    name = "ls_objectives"
    _launch.check_types(name, {"fpsi": (fpsi, torch.complex64),
                               "fd": (fd, torch.complex64),
                               "data": (data, torch.float32),
                               "gammas": (gammas, torch.float32)})
    t, s, nmodes, nd, nd2 = fpsi.shape
    k = gammas.numel()
    if (fd.shape != fpsi.shape or nd2 != nd
            or data.shape != (t, s, nd, nd) or gammas.dim() != 1):
        raise ValueError(f"{name}: inconsistent shapes fpsi "
                         f"{tuple(fpsi.shape)}, fd {tuple(fd.shape)}, data "
                         f"{tuple(data.shape)}, gammas {tuple(gammas.shape)}")
    bucket = step_bucket(k)  # raises outside 1..33
    dev = _launch.device_index(fpsi)
    fpsi, fd = fpsi.contiguous(), fd.contiguous()
    data, gammas = data.contiguous(), gammas.contiguous()
    per_sm = _launch.blocks_per_sm(
        name, "tk_ls_objectives_frame_blocks_per_sm", dev, bucket)
    grid = max(1, min(t * s, max(1, per_sm) * _launch.sms(dev)))
    # Pair loads where every frame starts on a pair: an even number of
    # pixels a frame and aligned storage (PyTorch's allocator aligns every
    # allocation; a view at an odd offset reads pixel by pixel).
    wide = int(nd % 2 == 0 and fpsi.data_ptr() % 16 == 0
               and fd.data_ptr() % 16 == 0 and data.data_ptr() % 8 == 0)
    partial = torch.empty(grid * k, dtype=torch.float64, device=fpsi.device)
    out = torch.empty(k, dtype=torch.float32, device=fpsi.device)
    _launch.launch(name, "tk_ls_objectives_frame", dev, fpsi.data_ptr(),
                   fd.data_ptr(), data.data_ptr(), gammas.data_ptr(),
                   partial.data_ptr(), out.data_ptr(), t * s, nmodes, nd, k,
                   bucket, _launch.MODEL_CODE[model], wide, grid)
    ls_objectives.launches += 1
    return out
