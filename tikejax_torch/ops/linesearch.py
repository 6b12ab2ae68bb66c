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
for what bounds it on an H100. It holds two kernels: the frame-major one,
which every call launches (a block walks whole frames, each thread sums its
pixels of a frame in float and the frame's sums go into the block's double
partials in a fixed order; templated on the step bucket
:func:`step_bucket`), and the pixel-major one it replaced, kept as a forced
``variant='pixel'`` of the private wrapper so that the two can be timed in
turns. Both sum over blocks in a fixed order: bitwise reproducible. On a
CUDA tensor the function launches a kernel or raises; on a CPU tensor it
runs :func:`ls_objectives_reference`. Each keeps an integer count of its
runs in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tikejax_torch.models import likelihoods
from tikejax_torch.ops import fused

# The kernels keep one accumulator per step in registers.
MAX_STEPS = 33
_THREADS = 256  # threads a block of either kernel
# The frame-major kernel's instantiations: the number of accumulators.
STEP_BUCKETS = (1, 2, 4, 8, 17, 33)


def step_bucket(k: int) -> int:
    """The frame-major kernel's step bucket for ``k`` steps: the smallest
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
    fused._check_model(model)
    gammas = torch.as_tensor(gammas, dtype=torch.float32, device=fpsi.device)
    if not fused._route("ls_objectives", fpsi):
        return ls_objectives_reference(fpsi, fd, data, gammas, model)
    return _ls_objectives_cuda(fpsi, fd, data, gammas, model)


ls_objectives.launches = 0
ls_objectives.variant = None  # of the last kernel launch: 'frame' or 'pixel'


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


@functools.cache
def frame_blocks_per_sm(device_index: int, bucket: int) -> int:
    """Resident blocks per SM of the frame-major kernel of step bucket
    ``bucket`` (one of :data:`STEP_BUCKETS`) on the card
    ``device_index``."""
    lib = fused._lib("ls_objectives")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        fused._check("ls_objectives", lib.tk_ls_objectives_frame_blocks_per_sm(
            bucket, ctypes.byref(per_sm)),
            f"occupancy query (frame, bucket {bucket})")
    return per_sm.value


def _ls_objectives_cuda(fpsi, fd, data, gammas, model, variant=None):
    """Launches ``ls_objectives``' kernel: the frame-major one (``variant``
    None or ``'frame'``) or the pixel-major one it replaced, forced with
    ``variant='pixel'``; any other variant raises."""
    name = "ls_objectives"
    if variant not in (None, "frame", "pixel"):
        raise ValueError(f"{name}: unknown variant {variant!r}; expected "
                         "'frame', 'pixel' or None")
    variant = variant or "frame"
    fused._check_types(name, {"fpsi": (fpsi, torch.complex64),
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
    lib = fused._lib(name)
    dev = fused._device_index(fpsi)
    fpsi, fd = fpsi.contiguous(), fd.contiguous()
    data, gammas = data.contiguous(), gammas.contiguous()
    model_code = fused._MODEL_CODE[model]
    if variant == "frame":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(t * s, max(1, frame_blocks_per_sm(dev, bucket))
                          * sms))
        # Pair loads where every frame starts on a pair: an even number of
        # pixels a frame and aligned storage (PyTorch's allocator aligns
        # every allocation; a view at an odd offset reads pixel by pixel).
        wide = int(nd % 2 == 0 and fpsi.data_ptr() % 16 == 0
                   and fd.data_ptr() % 16 == 0 and data.data_ptr() % 8 == 0)
    else:
        pixels = t * s * nd * nd
        grid = max(1, min(fused._resident_blocks(name, dev, nd, False),
                          -(-pixels // _THREADS)))
    partial = torch.empty(grid * k, dtype=torch.float64, device=fpsi.device)
    out = torch.empty(k, dtype=torch.float32, device=fpsi.device)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "frame":
            err = lib.tk_ls_objectives_frame(
                fpsi.data_ptr(), fd.data_ptr(), data.data_ptr(),
                gammas.data_ptr(), partial.data_ptr(), out.data_ptr(), t * s,
                nmodes, nd, k, bucket, model_code, wide, grid, stream)
        else:
            err = lib.tk_ls_objectives(
                fpsi.data_ptr(), fd.data_ptr(), data.data_ptr(),
                gammas.data_ptr(), partial.data_ptr(), out.data_ptr(),
                pixels, nmodes, nd, k, model_code, grid, stream)
    fused._check(name, err, f"kernel launch ({variant})")
    ls_objectives.launches += 1
    ls_objectives.variant = variant
    return out
