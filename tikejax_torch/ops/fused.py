"""Fused operators: the hand-written ``grad_fused``, ``fwd``,
``minf_fused``, ``grad_prb_fused``, ``adj``, ``adj_probe``,
``adj_residual`` and ``fwd_quad_stats`` kernels.

Counterpart of ``tikejax.ops.pallas_fused`` for the kernels that the solver
and ``reconstruct`` run. The first four gather the object patch of every
(angle, position, mode) frame, multiply by the probe and take the unitary
DFT of the zero-padded frame (plus, in split-operator mode, the frozen
``base`` farplane's frame); then

* ``grad_fused`` (replaces ``pallas_fused.py`` ``grad_fused``,
  ``_grad_kernel``) forms the likelihood factor and objective against the
  measured frame, takes the inverse DFT, multiplies by the conj probe, sums
  the modes and adds into the object gradient at each window: its kernel
  stores the cropped inverse frames of a chunk of frames into a scratch of
  at most ``FRAME_SCRATCH_BYTES``, and the tile kernel of
  ``tikejax_torch.ops.kernels.scatter_conj_probe`` sums each chunk into
  the gradient in scan order. It returns ``(grad (t, nz, n), minf ())``
  with ``grad = G^H(factor * (G psi + base))`` -- no factor 2: the solver
  supplies it;
* ``minf_fused`` (replaces ``minf_fused``, ``_minf_kernel``) stops at the
  objective: the frameless line search and the memory-bound Anderson
  safeguard evaluate candidates with it;
* ``fwd`` (replaces ``fwd``, ``_fwd_kernel``) writes the farplane
  ``(t, s, m, ndet, ndet)`` itself: the base freeze of the split refinement,
  the Anderson safeguard's candidate farplanes and the streamed
  (``nchunks > 1``) chunk farplanes;
* ``grad_prb_fused`` (replaces ``grad_prb_fused``, ``_grad_prb_kernel``) is
  ``grad_fused``'s twin for joint probe recovery: after the inverse DFT it
  multiplies by the conj object patch and sums over the positions into the
  probe gradient ``(t, m, nprb, nprb)``.

The other two read a farplane and apply the inverse DFT, cropped to the
probe window, to every frame:

* ``adj`` (replaces ``adj``, ``_adj_kernel``) multiplies by the conj probe,
  sums the modes and scatter-adds into the object ``(t, nz, n)``: its
  kernel stores the cropped inverse frames, chunk by chunk of positions,
  into a scratch of at most ``FRAME_SCRATCH_BYTES``, and the tile kernel of
  ``tikejax_torch.ops.kernels.scatter_conj_probe`` sums each chunk into
  the object in scan order, continuing from the partial object the chunk
  before it stored;
* ``adj_probe`` (replaces ``adj_probe``, ``_adj_probe_kernel``) multiplies
  by the conj object patch and sums over the positions into the probe
  ``(t, m, nprb, nprb)``.

They are the fused tiers' operator-level adjoints
(``diffraction.adj_raw`` / ``adj_probe_raw``), which the streamed gradient
pass runs chunk by chunk.

Two more serve the materialized memory mode of the solver, which keeps
``G psi`` in memory between the forward pass and the gradient tail:

* ``adj_residual`` (replaces ``adj_residual``, ``_adj_residual_kernel``)
  is ``grad_fused``'s second half reading that farplane: the likelihood
  factor and objective, the inverse DFT, then (the tile kernel, chunk by
  chunk, as ``grad_fused``) the conj-probe multiply, the mode sum and the
  scatter into the object gradient;
* ``fwd_quad_stats`` (replaces ``fwd_quad_stats``, ``_fwd_quad_kernel``)
  is ``fwd``'s forward frame of a direction, reduced at once against the
  held farplane into the line search's per-pixel statistics ``a``, ``b``,
  ``c`` (the direction farplane is never stored).

``grad_fused``, ``grad_prb_fused`` and ``minf_fused`` never allocate a
farplane or a nearplane, which is why they exist: at 16384 positions of
128^2 the farplane alone is 2.1 GB (8.6 GB with 4 modes).

The CUDA sources are ``tikejax_torch/csrc/<name>.cu`` with their shared
device code in ``csrc/dft_frame.cuh`` (built by
``tikejax_torch.utils.cuda_build``). All eight have two hand-written
kernels, and :func:`dft_variant` picks one from the shapes alone, before
the launch, the same for all eight (a line search compares the objectives
of ``grad_fused``, ``minf_fused`` and ``grad_prb_fused``, which must
therefore compute a frame's farplane with the same arithmetic, ``fwd``
stores that farplane as a frozen base or an Anderson candidate that they
read, ``fwd_quad_stats`` forms the same farplane of a direction, and
``adj`` is ``fwd``'s adjoint through the same transform):
``'fft'`` for a detector side of 16, 32, 64 or 128 -- one frame per block,
the whole complex frame in shared memory, transformed in place by a
register-resident radix FFT (29 times less arithmetic than the matrix
products at 128^2; shared-memory sweeps and the one read or write of a
frame in device memory bound it) -- and ``'gemm'`` for every other size:
the DFT as complex
matrix products per frame and mode, ``ndet*nprb*(nprb+ndet)`` complex
multiply-adds per DFT application, all on the SIMT fp32 units, in
shared-memory tiled GEMMs whose per-frame intermediates sit in per-block
scratch sized by the grid (never by the number of positions). Neither
gives way to the other or to the plain version: a CUDA tensor launches the
chosen kernel or raises.

The base. The JAX package accepts the frozen base as a complex array or as
the (re, im) f32 pair that ``fwd(split_out=True)`` emits, because on the
TPU the complex assembly of the pair is a second base-sized buffer. Here
PyTorch's complex64 already has the kernels' interleaved layout, so that
reason has no counterpart: ``fwd(split_out=True)`` returns the
``torch.view_as_real`` halves of the one complex output, and every function
takes a base either as a complex tensor or as such a pair of halves, which
it reads as the complex tensor they view, without a copy.

Precision tiers: the JAX package runs ``fused_mx``'s forward at bf16x3
Karatsuba (~8e-6) and its adjoint at single-pass bf16 (~2.5e-3), and the
base freeze at ``fused_hp``'s full fp32. These kernels compute every DFT
with plain fp32 multiply-adds, which meets or beats every tier's accuracy,
so every ``fused*`` tier maps to them and the ``precision`` /
``adj_precision`` tags are accepted and ignored.

Determinism: the three object scatters (``adj``, ``grad_fused``,
``adj_residual``) are bitwise repeatable, as the TPU kernels' are: each
object pixel sums its positions' contributions in increasing scan order,
the TPU kernel's order, in double, whatever the chunk of positions
(``scatter_conj_probe``'s tile kernel, continued chunk after chunk from the
stored running sums in double, rounded to fp32 once). The one-pass kernels
with fp32 atomics that this replaced stay only for timing the two in
turns, forced with ``variant='atomic'`` (``_adj_cuda``,
``_grad_fused_cuda``, ``_adj_residual_cuda``). The price is a frame
scratch of at most ``FRAME_SCRATCH_BYTES`` on the frameless main path and
the second pass: ``grad_fused`` takes longer than the atomic kernel did,
which PERF.md measures in turns; the reference's contract is bitwise, so
the port pays it. ``grad_fused`` and ``adj_residual`` run their frame
kernel on each chunk with the grid of one launch on all frames and carry
each thread's objective sum from one launch to the next, so their
objectives are the bits of one launch, and ``grad_fused``'s is
``minf_fused``'s. The probe reductions (``grad_prb_fused``, ``adj_probe``)
add each block's frames into a block-owned partial without atomics and sum
the partials over the blocks in a fixed order, so they are bitwise
reproducible, as is every objective (summed in double in a fixed order)
and ``fwd_quad_stats`` (no reduction over frames).

Each function takes CPU or CUDA tensors. On a CUDA tensor it launches its
kernel or raises; on a CPU tensor it runs its ``*_reference``, the plain
PyTorch version built from the oracle operators. Each keeps an integer
count of its runs in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from tikejax_torch.models import likelihoods
from tikejax_torch.ops import _launch, diffraction, kernels
from tikejax_torch.ops._launch import fft_launch_config  # noqa: F401
from tikejax_torch.ops._launch import fft_threads
from tikejax_torch.utils import profiling

# The frame scratch of the three object scatters (adj, grad_fused,
# adj_residual): the cropped inverse frames (complex64) of a chunk of
# positions, which the tile kernel then sums into the object. Chunks stay
# within this many bytes: the stream path's 1024-frame chunk of 128^2 (128
# MiB) fits whole, the headline's 16384 frames take 4 chunks and the 4-mode
# farplane (8 GiB of frames) 16. It is a constant, whatever the number of
# positions, so the frameless path stays frameless. Smaller chunks cost
# more than the L2 they keep the frames in saves: on an H100 80GB HBM3
# (700 W) the headline grad_fused took 5.13-5.20 ms with 512 MiB chunks,
# 5.46-5.52 with 128 and 6.07-6.66 with 32 (PERF.md, chip_smoke.py), the
# tile kernel's launches and walks being paid once a chunk.
FRAME_SCRATCH_BYTES = 512 * 2**20


def adj_chunk(t: int, s: int, nmodes: int, nprb: int) -> int:
    """Positions of each angle that one chunk of ``adj`` takes: as many as
    keep the frame scratch within ``FRAME_SCRATCH_BYTES``, at least one, at
    most ``s``."""
    per_position = max(1, t * nmodes * nprb * nprb * 8)
    return max(1, min(s, FRAME_SCRATCH_BYTES // per_position))


def frame_chunk(nmodes: int, nprb: int) -> int:
    """Frames (of any angle) that one chunk of ``grad_fused`` or
    ``adj_residual`` takes: as many as keep the frame scratch within
    ``FRAME_SCRATCH_BYTES``, at least one."""
    return max(1, FRAME_SCRATCH_BYTES // max(1, nmodes * nprb * nprb * 8))


def frame_chunks(t: int, s: int, chunk: int) -> list:
    """The chunks of the ``t * s`` frames (frame ``f = angle * s +
    position``) of ``chunk`` frames each, in order: ``[(g0, g1, segments)]``
    where each segment ``(th0, th1, a, b)`` is one launch of the tile
    kernel on positions ``[a, b)`` of angles ``[th0, th1)`` (whole angles
    of a chunk go in one segment). A segment with ``a > 0`` continues from
    the running sums, one with ``b < s`` leaves them for the next chunk.
    Pure: no device is involved."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    out = []
    frames = t * s
    for g0 in range(0, frames, chunk):
        g1 = min(frames, g0 + chunk)
        segments, g = [], g0
        while g < g1:
            th, a = divmod(g, s)
            b = min(s, g1 - th * s)
            if (a == 0 and b == s and segments and segments[-1][2] == 0
                    and segments[-1][3] == s and segments[-1][1] == th):
                segments[-1] = (segments[-1][0], th + 1, 0, s)
            else:
                segments.append((th, th + 1, a, b))
            g = th * s + b
        out.append((g0, g1, segments))
    return out


def _scatter_segments(near, g0, segments, s, scan_int, prb, nz, n, out,
                      partial):
    """The tile kernel on each segment of a chunk whose cropped frames
    (frame ``g0`` first) ``near`` holds: into ``out``, continuing from and
    leaving running sums in ``partial`` where a segment splits an angle;
    each launch skips the chunks of its positions whose box (the whole
    scan's, ``kernels.scatter_boxes``) misses its tile."""
    m, p = prb.shape[1], prb.shape[-1]
    boxes = kernels.scatter_boxes(scan_int, nz, n, p)
    for th0, th1, a, b in segments:
        k, c = th1 - th0, b - a
        start = (th0 * s + a - g0) * m * p * p
        frames = near[start:start + k * c * m * p * p].view(k, c, m, p, p)
        kernels._scatter_conj_probe_cuda(
            frames, scan_int[th0:th1, a:b], prb[th0:th1], nz, n,
            out=out[th0:th1],
            partial=None if partial is None else partial[th0:th1],
            from_partial=a > 0, last=b == s, boxes=boxes[th0:th1], first=a)


def _chunk_arg(name, chunk, nmodes, nprb) -> int:
    """The frames a chunk takes: ``chunk``, or :func:`frame_chunk` for
    None; below one raises."""
    chunk = frame_chunk(nmodes, nprb) if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")
    return chunk


def _scan_order(wrapper, launch, prb, scan_int, t, s, nz, n, chunk, grid,
                threads, device):
    """The object gradient of ``wrapper`` (grad_fused or adj_residual) in
    scan order:
    ``launch(g0, g1, first, last, near, carry)`` runs the frame kernel on
    frames [g0, g1) into the scratch ``near`` (pointers), once per chunk of
    ``chunk`` frames, each followed by the tile kernel on the chunk's
    segments (:func:`frame_chunks`); each thread's
    objective sum waits in ``carry`` (``grid * threads`` doubles) between
    the chunks, and the running sums of an angle split between chunks in
    a complex128 object. Each frame-kernel launch adds one to
    ``wrapper.launches``, and the chunk's (angle, position, mode) frames
    to ``wrapper.frames``. Each chunk's frame-kernel launch is a
    ``fused.frame_pass`` span and its tile launches a ``fused.tile_scatter``
    span."""
    frames = t * s
    # Every pixel is stored by the tile launches, covered or not.
    grad = torch.empty((t, nz, n), dtype=torch.complex64, device=device)
    if frames == 0:
        return grad.zero_()
    m, p = prb.shape[1], prb.shape[-1]
    chunk = min(chunk, frames)
    plan = frame_chunks(t, s, chunk)
    near = torch.empty(chunk * m * p * p, dtype=torch.complex64,
                       device=device)
    carry = (torch.empty(grid * threads, dtype=torch.float64, device=device)
             if len(plan) > 1 else None)
    split = any(a > 0 or b < s for _, _, segments in plan
                for _, _, a, b in segments)
    running = (torch.empty((t, nz, n), dtype=torch.complex128, device=device)
               if split else None)
    for g0, g1, segments in plan:
        with profiling.span("fused.frame_pass"):
            launch(g0, g1, int(g0 == 0), int(g1 == frames), near.data_ptr(),
                   None if carry is None else carry.data_ptr())
        wrapper.launches += 1
        wrapper.frames += (g1 - g0) * m
        with profiling.span("fused.tile_scatter"):
            _scatter_segments(near, g0, segments, s, scan_int, prb, nz, n,
                              grad, running)
    return grad


# Detector sides of the FFT kernels: a power of two whose padded complex
# frame fits the 227 KiB of shared memory a block can have (140,288 bytes
# at 128, plus a 64 KiB intensity plane with several modes).
_FFT_NDET = (16, 32, 64, 128)


def dft_variant(nprb: int, ndet: int, nmodes: int) -> str:
    """Which of their two hand-written kernels ``grad_fused``,
    ``minf_fused``, ``grad_prb_fused``, ``fwd``, ``adj``, ``adj_probe``,
    ``adj_residual`` and ``fwd_quad_stats`` launch on a CUDA tensor of these
    sizes: ``'fft'`` (the frame's FFT in shared memory) for ``ndet`` 16, 32,
    64 or 128, ``'gemm'`` (DFT matrix products) for any other size. A pure
    function of the shapes; ``nprb > ndet`` raises as the kernels do."""
    _launch.check_sizes("dft_variant", nprb, ndet)
    if nmodes < 1:
        raise ValueError(f"dft_variant: nmodes must be >= 1, got {nmodes}")
    return "fft" if ndet in _FFT_NDET else "gemm"


def fft_body(ndet: int, nmodes: int) -> str:
    """Which body of their ``'fft'`` variant ``grad_fused`` and
    ``minf_fused`` launch: ``'fft_regs'`` (the column pass's second stage
    and the likelihood -- for ``grad_fused`` also the inverse column pass
    -- fused in registers: 12 sweeps of the frame through shared memory,
    ``minf_fused`` 6) at ``ndet`` 128 with one mode, ``'fft_smem'`` (the
    whole frame transformed stage by stage in shared memory) at every other
    FFT size, with or without a base or the data prefetch. The two give the
    same bits. A pure function of the shapes."""
    return "fft_regs" if ndet == 128 and nmodes == 1 else "fft_smem"


def _pick_variant(name, variant, nprb, ndet, nmodes):
    """The variant to launch: the shapes' own, or the one the caller
    forces, which must be able to run these shapes."""
    _launch.check_sizes(name, nprb, ndet)
    chosen = dft_variant(nprb, ndet, nmodes)
    if variant is None:
        return chosen
    if variant not in ("fft", "gemm"):
        raise ValueError(f"{name}: unknown variant {variant!r}; expected "
                         "'fft', 'gemm' or None")
    if variant == "fft" and chosen != "fft":
        raise ValueError(f"{name}: the 'fft' variant takes ndet in "
                         f"{_FFT_NDET}, got ndet={ndet}")
    return variant


# The bodies a caller of each kernel with two FFT bodies may force.
_FORCED_BODIES = {"grad_fused": ("fft_smem", "atomic"),
                  "minf_fused": ("fft_smem",)}


def _pick_body(name, variant, nprb, ndet, nmodes):
    """(variant, body) of a ``grad_fused`` or ``minf_fused`` launch: the
    body is :func:`fft_body`'s on the ``'fft'`` variant, ``'fft_smem'``
    where the caller forces it (``variant='fft_smem'``), ``'atomic'`` for
    ``grad_fused``'s forced one-pass kernel (which the FFT variant's shapes
    run) and ``'gemm'`` on that variant."""
    forced = variant if variant in _FORCED_BODIES[name] else None
    variant = _pick_variant(name, "fft" if forced else variant, nprb, ndet,
                            nmodes)
    if variant == "gemm":
        return variant, "gemm"
    return variant, forced or fft_body(ndet, nmodes)


def _base_complex(base):
    """The base as one complex tensor, without a copy: a complex tensor as
    given, or the tensor whose ``view_as_real`` halves the (re, im) pair
    is (what ``fwd(split_out=True)`` returns); any other pair raises."""
    if not isinstance(base, (tuple, list)):
        return base
    re, im = base
    if (re.dtype != im.dtype or re.device != im.device
            or re.shape != im.shape or re.stride() != im.stride()
            or re.untyped_storage().data_ptr()
            != im.untyped_storage().data_ptr()
            or im.data_ptr() != re.data_ptr() + re.element_size()
            or any(st % 2 for st in re.stride())):
        raise ValueError("base: an (re, im) pair must be the view_as_real "
                         "halves of one complex tensor, as "
                         "fwd(split_out=True) returns")
    return torch.view_as_complex(
        re.as_strided(tuple(re.shape) + (2,), re.stride() + (1,)))


def grad_fused(psi: torch.Tensor, data: torch.Tensor,
               scan_int: torch.Tensor, prb: torch.Tensor, ndet: int,
               model: str, precision=None, adj_precision=None, base=None):
    """Likelihood gradient w.r.t. the object plus the objective in one
    pass, without a farplane in memory.

    Args:
      psi: ``(ntheta, nz, n)`` complex object.
      data: ``(ntheta, nscan, ndet, ndet)`` real measured intensities.
      scan_int: ``(ntheta, nscan, 2)`` int32 (y, x) offsets; a row < 0
        marks a masked dummy position.
      prb: ``(ntheta, nmodes, nprb, nprb)`` complex probe.
      model: 'gaussian' or 'poisson'.
      precision, adj_precision: the JAX package's tier tags; ignored.
      base: the frozen base farplane ``(ntheta, nscan, nmodes, ndet,
        ndet)``, complex or its ``view_as_real`` (re, im) halves (what
        ``fwd(split_out=True)`` returns); the forward field is then
        ``G psi + base`` (split-operator refinement).

    Returns:
      (grad ``(ntheta, nz, n)`` like ``psi``, minf ``()`` real).
    """
    _launch.check_model(model)
    if not _launch.route("grad_fused", psi):
        return grad_fused_reference(psi, data, scan_int, prb, ndet, model,
                                    base=base)
    return _grad_fused_cuda(psi, data, scan_int, prb, ndet, model, base)


grad_fused.launches = 0
# The (angle, position, mode) frames of the scan-order chunks, each taken
# by a fused.frame_pass and a fused.tile_scatter span.
grad_fused.frames = 0
grad_fused.variant = None  # of the last kernel launch: 'fft' or 'gemm'
# Of the last launch: 'fft_regs' or 'fft_smem' (fft_body), 'gemm' or
# 'atomic'; and the frame-kernel launches of each since import.
grad_fused.body = None
grad_fused.body_launches = dict.fromkeys(
    ("fft_regs", "fft_smem", "gemm", "atomic"), 0)


def grad_fused_reference(psi: torch.Tensor, data: torch.Tensor,
                         scan_int: torch.Tensor, prb: torch.Tensor,
                         ndet: int, model: str, precision=None,
                         adj_precision=None, base=None):
    """Plain PyTorch version of :func:`grad_fused`, on any device: oracle
    forward (plus the base), likelihood residual, oracle adjoint. The
    objective skips masked positions (scan row < 0), as the kernel does."""
    grad_fused_reference.launches += 1
    minf_fn, resid_fn = likelihoods.get_model(model)
    nz, n = psi.shape[-2:]
    far = diffraction.fwd_raw(psi, scan_int, prb, ndet, kernel="xla")
    if base is not None:
        far = far + _base_complex(base)
    grad = diffraction.adj_raw(resid_fn(far, data), scan_int, prb, nz, n,
                               kernel="xla")
    return grad, _valid_minf(minf_fn, far, data, scan_int)


grad_fused_reference.launches = 0


def minf_fused(psi: torch.Tensor, data: torch.Tensor,
               scan_int: torch.Tensor, prb: torch.Tensor, ndet: int,
               model: str, precision=None, base=None):
    """The objective at ``psi`` (``G psi + base`` with a base) with nothing
    farplane-sized in memory: the forward half of :func:`grad_fused`.
    Arguments as :func:`grad_fused`. Returns minf ``()`` real."""
    _launch.check_model(model)
    if not _launch.route("minf_fused", psi):
        return minf_fused_reference(psi, data, scan_int, prb, ndet, model,
                                    base=base)
    return _minf_fused_cuda(psi, data, scan_int, prb, ndet, model, base)


minf_fused.launches = 0
minf_fused.variant = None  # of the last kernel launch: 'fft' or 'gemm'
# Of the last launch: 'fft_regs' or 'fft_smem' (fft_body) or 'gemm'; and
# the launches of each since import.
minf_fused.body = None
minf_fused.body_launches = dict.fromkeys(("fft_regs", "fft_smem", "gemm"), 0)


def minf_fused_reference(psi: torch.Tensor, data: torch.Tensor,
                         scan_int: torch.Tensor, prb: torch.Tensor,
                         ndet: int, model: str, precision=None, base=None):
    """Plain PyTorch version of :func:`minf_fused`, on any device: the
    oracle farplane (plus the base) and the likelihood, skipping masked
    positions."""
    minf_fused_reference.launches += 1
    far = diffraction.fwd_raw(psi, scan_int, prb, ndet, kernel="xla")
    if base is not None:
        far = far + _base_complex(base)
    minf_fn, _ = likelihoods.get_model(model)
    return _valid_minf(minf_fn, far, data, scan_int)


minf_fused_reference.launches = 0


def fwd(psi: torch.Tensor, scan_int: torch.Tensor, prb: torch.Tensor,
        ndet: int, precision=None, base=None, split_out: bool = False):
    """Forward farplane ``DFT2(pad(psi[patch(s)] * prb[m]))`` (+ ``base``),
    ``(ntheta, nscan, nmodes, ndet, ndet)`` complex; a masked position
    (scan row < 0) gets a zero frame (plus the base). With ``split_out``,
    the (re, im) real views of that complex tensor (see the module note on
    the base). ``precision`` is the JAX package's tier tag, ignored."""
    if not _launch.route("fwd", psi):
        return fwd_reference(psi, scan_int, prb, ndet, base=base,
                             split_out=split_out)
    out = _fwd_cuda(psi, scan_int, prb, ndet, base)
    return torch.view_as_real(out).unbind(-1) if split_out else out


fwd.launches = 0
fwd.variant = None  # of the last kernel launch: 'fft' or 'gemm'


def fwd_reference(psi: torch.Tensor, scan_int: torch.Tensor,
                  prb: torch.Tensor, ndet: int, precision=None, base=None,
                  split_out: bool = False):
    """Plain PyTorch version of :func:`fwd`, on any device: the oracle
    forward operator (plus the base)."""
    fwd_reference.launches += 1
    far = diffraction.fwd_raw(psi, scan_int, prb, ndet, kernel="xla")
    if base is not None:
        far = far + _base_complex(base)
    return torch.view_as_real(far).unbind(-1) if split_out else far


fwd_reference.launches = 0


def grad_prb_fused(psi: torch.Tensor, data: torch.Tensor,
                   scan_int: torch.Tensor, prb: torch.Tensor, ndet: int,
                   model: str, precision=None, adj_precision=None):
    """Likelihood gradient w.r.t. the probe plus the objective in one pass,
    without a farplane in memory (joint probe recovery). Arguments as
    :func:`grad_fused` (no base: the JAX package's joint recovery has no
    split-operator mode). Returns (grad_prb ``(ntheta, nmodes, nprb,
    nprb)`` like ``prb``, minf ``()`` real)."""
    _launch.check_model(model)
    if not _launch.route("grad_prb_fused", psi):
        return grad_prb_fused_reference(psi, data, scan_int, prb, ndet,
                                        model)
    return _grad_prb_fused_cuda(psi, data, scan_int, prb, ndet, model)


grad_prb_fused.launches = 0
grad_prb_fused.variant = None  # of the last kernel launch


def grad_prb_fused_reference(psi: torch.Tensor, data: torch.Tensor,
                             scan_int: torch.Tensor, prb: torch.Tensor,
                             ndet: int, model: str, precision=None,
                             adj_precision=None):
    """Plain PyTorch version of :func:`grad_prb_fused`, on any device:
    oracle forward, likelihood residual, oracle probe adjoint; the
    objective skips masked positions (scan row < 0), as the kernel does."""
    grad_prb_fused_reference.launches += 1
    minf_fn, resid_fn = likelihoods.get_model(model)
    far = diffraction.fwd_raw(psi, scan_int, prb, ndet, kernel="xla")
    grad = diffraction.adj_probe_raw(resid_fn(far, data), scan_int, psi,
                                     prb.shape[-1], kernel="xla")
    return grad, _valid_minf(minf_fn, far, data, scan_int)


grad_prb_fused_reference.launches = 0


def adj(farplane: torch.Tensor, scan_int: torch.Tensor, prb: torch.Tensor,
        nz: int, n: int, precision=None):
    """Adjoint w.r.t. the object: inverse DFT of every frame of
    ``farplane`` ``(ntheta, nscan, nmodes, ndet, ndet)``, crop, conj-probe
    multiply, mode sum and overlap scatter-add. Returns ``(ntheta, nz,
    n)``; a masked position (scan row < 0) adds nothing. ``precision`` is
    the JAX package's tier tag, ignored."""
    if not _launch.route("adj", farplane):
        return adj_reference(farplane, scan_int, prb, nz, n)
    return _adj_cuda(farplane, scan_int, prb, nz, n)


adj.launches = 0  # frame-kernel launches: one per chunk of positions
adj.variant = None  # of the last kernel launch: 'fft' or 'gemm'


def adj_reference(farplane: torch.Tensor, scan_int: torch.Tensor,
                  prb: torch.Tensor, nz: int, n: int, precision=None):
    """Plain PyTorch version of :func:`adj`: the oracle adjoint."""
    adj_reference.launches += 1
    return diffraction.adj_raw(farplane, scan_int, prb, nz, n, kernel="xla")


adj_reference.launches = 0


def adj_probe(farplane: torch.Tensor, scan_int: torch.Tensor,
              psi: torch.Tensor, nprb: int, precision=None):
    """Adjoint w.r.t. the probe: inverse DFT of every frame of
    ``farplane``, crop, conj(object patch) multiply and sum over the
    positions. Returns ``(ntheta, nmodes, nprb, nprb)``; a masked position
    adds nothing. ``precision`` is the JAX package's tier tag, ignored."""
    if not _launch.route("adj_probe", farplane):
        return adj_probe_reference(farplane, scan_int, psi, nprb)
    return _adj_probe_cuda(farplane, scan_int, psi, nprb)


adj_probe.launches = 0
adj_probe.variant = None  # of the last kernel launch: 'fft' or 'gemm'


def adj_probe_reference(farplane: torch.Tensor, scan_int: torch.Tensor,
                        psi: torch.Tensor, nprb: int, precision=None):
    """Plain PyTorch version of :func:`adj_probe`: the oracle adjoint."""
    adj_probe_reference.launches += 1
    return diffraction.adj_probe_raw(farplane, scan_int, psi, nprb,
                                     kernel="xla")


adj_probe_reference.launches = 0


def adj_residual(farplane: torch.Tensor, data: torch.Tensor,
                 scan_int: torch.Tensor, prb: torch.Tensor, nz: int, n: int,
                 model: str, precision=None):
    """The gradient tail from a farplane held in memory, in one pass: the
    likelihood factor and objective of ``farplane`` ``(ntheta, nscan,
    nmodes, ndet, ndet)`` against ``data``, the inverse DFT of ``factor *
    farplane``, the conj-probe multiply, the mode sum and the overlap
    scatter. A masked position (scan row < 0) adds nothing to either
    output. ``precision`` is the JAX package's tier tag, ignored.

    Returns:
      (grad ``(ntheta, nz, n)`` like ``farplane``, minf ``()`` real), with
      ``grad = G^H(factor * farplane)`` (no factor 2).
    """
    _launch.check_model(model)
    if not _launch.route("adj_residual", farplane):
        return adj_residual_reference(farplane, data, scan_int, prb, nz, n,
                                      model)
    return _adj_residual_cuda(farplane, data, scan_int, prb, nz, n, model)


adj_residual.launches = 0
adj_residual.frames = 0  # as grad_fused's
adj_residual.variant = None  # of the last kernel launch: 'fft' or 'gemm'


def adj_residual_reference(farplane: torch.Tensor, data: torch.Tensor,
                           scan_int: torch.Tensor, prb: torch.Tensor,
                           nz: int, n: int, model: str, precision=None):
    """Plain PyTorch version of :func:`adj_residual`: the likelihood
    residual, the oracle adjoint and the objective over the unmasked
    positions."""
    adj_residual_reference.launches += 1
    minf_fn, resid_fn = likelihoods.get_model(model)
    grad = diffraction.adj_raw(resid_fn(farplane, data), scan_int, prb, nz,
                               n, kernel="xla")
    return grad, _valid_minf(minf_fn, farplane, data, scan_int)


adj_residual_reference.launches = 0


def fwd_quad_stats(dpsi: torch.Tensor, scan_int: torch.Tensor,
                   prb: torch.Tensor, fpsi: torch.Tensor, precision=None):
    """Line-search statistics in one pass: the farplane ``fd`` of
    ``(dpsi, prb)``, reduced against the held farplane ``fpsi``
    ``(ntheta, nscan, nmodes, ndet, ndet)`` into the per-pixel
    coefficients of ``|fpsi + gamma fd|^2`` summed over the modes,

        a = sum_m |fpsi|^2,  b = sum_m Re(conj(fpsi) fd),  c = sum_m |fd|^2,

    without storing ``fd``. For the probe direction pass ``(psi, dprb)``
    in place of ``(dpsi, prb)``. At a masked position (scan row < 0) the
    direction frame is zero and ``a`` is masked. ``precision`` is the JAX
    package's tier tag, ignored.

    Returns:
      (a, b, c), each ``(ntheta, nscan, ndet, ndet)`` real.
    """
    if not _launch.route("fwd_quad_stats", dpsi):
        return fwd_quad_stats_reference(dpsi, scan_int, prb, fpsi)
    return _fwd_quad_stats_cuda(dpsi, scan_int, prb, fpsi)


fwd_quad_stats.launches = 0
fwd_quad_stats.variant = None  # of the last kernel launch: 'fft' or 'gemm'


def fwd_quad_stats_reference(dpsi: torch.Tensor, scan_int: torch.Tensor,
                             prb: torch.Tensor, fpsi: torch.Tensor,
                             precision=None):
    """Plain PyTorch version of :func:`fwd_quad_stats`: the oracle forward
    of the direction and the three statistics, ``a`` masked."""
    fwd_quad_stats_reference.launches += 1
    fd = diffraction.fwd_raw(dpsi, scan_int, prb, fpsi.shape[-1],
                             kernel="xla")
    valid = (scan_int[..., 0] >= 0)[..., None, None]
    a = likelihoods.total_intensity(fpsi) * valid
    b = torch.sum((torch.conj(fpsi) * fd).real, dim=2)
    return a, b, likelihoods.total_intensity(fd)


fwd_quad_stats_reference.launches = 0


def _valid_minf(minf_fn, far, data, scan_int):
    """The objective over the positions whose scan row is >= 0."""
    valid = scan_int[..., 0] >= 0
    if not bool(valid.all()):
        far, data = far[valid][None], data[valid][None]
    return minf_fn(far, data)


# -- the CUDA path -------------------------------------------------------

def _fft_prefetch(nmodes, data):
    """Whether the FFT variant fetches each measured frame into shared
    memory a frame ahead: wherever it can (one mode, ``data`` 16-byte
    aligned)."""
    return nmodes == 1 and data.data_ptr() % 16 == 0


def _check_inputs(name, psi, scan_int, prb, ndet, data=None):
    """Device, dtype and shape checks of the forward kernels' common
    inputs; returns (t, nz, n, nmodes, nprb, nscan)."""
    t, nz, n = psi.shape
    _, nmodes, nprb, _ = prb.shape
    s = scan_int.shape[1]
    expect = {"psi": (psi, torch.complex64), "prb": (prb, torch.complex64),
              "scan_int": (scan_int, torch.int32)}
    if data is not None:
        expect["data"] = (data, torch.float32)
    _launch.check_types(name, expect)
    if (prb.shape[0] != t or scan_int.shape != (t, s, 2)
            or prb.shape[-1] != nprb
            or (data is not None and data.shape != (t, s, ndet, ndet))):
        raise ValueError(
            f"{name}: inconsistent shapes psi {tuple(psi.shape)}, prb "
            f"{tuple(prb.shape)}, scan_int {tuple(scan_int.shape)}"
            + (f", data {tuple(data.shape)}" if data is not None else "")
            + f", ndet {ndet}")
    _launch.check_sizes(name, nprb, ndet)
    return t, nz, n, nmodes, nprb, s


def _check_farplane(name, farplane, scan_int, other, other_name, lead):
    """Checks of the adjoint kernels' inputs: ``farplane`` (t, s, m, d,
    d), ``scan_int`` (t, s, 2) and ``other`` (the probe or the object)
    whose leading dimensions must be ``lead``; returns (t, s, m, d)."""
    t, s, m, d, d2 = farplane.shape
    _launch.check_types(name, {"farplane": (farplane, torch.complex64),
                               other_name: (other, torch.complex64),
                               "scan_int": (scan_int, torch.int32)})
    if d2 != d or scan_int.shape != (t, s, 2) or other.shape[:len(lead)] != (
            lead):
        raise ValueError(
            f"{name}: inconsistent shapes farplane {tuple(farplane.shape)}, "
            f"{other_name} {tuple(other.shape)}, scan_int "
            f"{tuple(scan_int.shape)}")
    return t, s, m, d


def _base_ptr(name, base, shape, device):
    """Pointer to a base on the card (None without one); never copies. The
    base, or the complex tensor its (re, im) pair views, must be a
    contiguous complex64 tensor of ``shape``."""
    if base is None:
        return None
    b = _base_complex(base)
    if (b.device != device or b.dtype != torch.complex64
            or tuple(b.shape) != shape or not b.is_contiguous()):
        raise ValueError(
            f"{name}: base must be a contiguous complex64 tensor of shape "
            f"{shape} on {device} (or its view_as_real halves), got "
            f"{b.dtype} {tuple(b.shape)} with strides {b.stride()} on "
            f"{b.device}")
    return b.data_ptr()


def _check_aligned(name, farplane):
    """The 'fft' variants read a farplane 16 bytes at a time: its storage
    must be 16-byte aligned (PyTorch's allocator aligns every allocation;
    a view at an odd complex offset is not)."""
    if farplane.data_ptr() % 16:
        raise ValueError(f"{name}: the 'fft' variant reads the farplane 16 "
                         "bytes at a time; its storage must be 16-byte "
                         "aligned")


# Threads of a block of the DFT-GEMM kernels (dft_frame.cuh kThreads).
_GEMM_THREADS = 256


def _grad_fused_cuda(psi, data, scan_int, prb, ndet, model, base,
                     variant=None, chunk=None):
    """Launches ``grad_fused``'s kernels: for each chunk of ``chunk``
    consecutive frames (default :func:`frame_chunk`), the frame kernel --
    the variant :func:`dft_variant` names for these shapes, or the one
    forced with ``variant`` (``'gemm'`` takes every size, ``'fft'`` raises
    off its sizes) -- into the scratch, then ``scatter_conj_probe``'s tile
    kernel from it into the gradient in scan order (:func:`frame_chunks`).
    ``variant='atomic'`` forces the one-pass FFT kernel with fp32 atomics
    that this design replaced (FFT sizes, no base), to time the two in
    turns. Within the FFT variant :func:`fft_body` picks the body from
    the shapes; ``variant='fft_smem'`` forces the shared-memory body where
    the fused one would run, to compare the two. The FFT variant fetches
    each measured frame a frame ahead where :func:`_fft_prefetch` allows.
    Each frame-kernel launch adds one to ``grad_fused.launches`` and to its
    body's count in ``grad_fused.body_launches``."""
    name = "grad_fused"
    t, nz, n, nmodes, nprb, s = _check_inputs(name, psi, scan_int, prb,
                                              ndet, data)
    base_p = _base_ptr(name, base, (t, s, nmodes, ndet, ndet), psi.device)
    if variant == "atomic" and base is not None:
        raise ValueError("grad_fused: the atomic kernel takes no base")
    variant, body = _pick_body(name, variant, nprb, ndet, nmodes)
    chunk = _chunk_arg(name, chunk, nmodes, nprb)
    dev = _launch.device_index(psi)
    psi, prb = psi.contiguous(), prb.contiguous()
    data, scan_int = data.contiguous(), scan_int.contiguous()
    if variant == "fft":
        threads = fft_threads(ndet)
        prefetch = _fft_prefetch(nmodes, data)
        grid = _launch.fft_grid(name, dev, t * s, ndet,
                                int(nmodes > 1 or prefetch), base is not None,
                                "fft_regs" if body == "fft_regs"
                                else "fft_smem")
    else:
        per_block = nmodes * ndet * (nprb + ndet)  # complex elements
        grid = _launch.gemm_grid(name, dev, t * s, ndet, base is not None,
                                 8 * per_block)
        scratch = torch.empty(2 * grid * per_block, dtype=torch.float32,
                              device=psi.device)
        threads = _GEMM_THREADS
    partial = torch.empty(grid, dtype=torch.float64, device=psi.device)
    model_code = _launch.MODEL_CODE[model]
    if body == "atomic":
        grad = torch.zeros((t, nz, n), dtype=torch.complex64,
                           device=psi.device)
        _launch.launch(name, "tk_grad_fused_atomic_fft", dev, psi.data_ptr(),
                       prb.data_ptr(), data.data_ptr(), scan_int.data_ptr(),
                       grad.data_ptr(), partial.data_ptr(), t, s, nz, n,
                       nmodes, nprb, ndet, model_code, int(prefetch), grid,
                       threads)
        grad_fused.launches += 1
        grad_fused.body_launches["atomic"] += 1
        grad_fused.variant = grad_fused.body = "atomic"
        return grad, partial.sum().to(torch.float32)
    symbol = _launch.fft_entry(name, body)

    def launch(g0, g1, first, last, near, carry):
        if variant == "fft":
            _launch.launch(name, symbol, dev, psi.data_ptr(), prb.data_ptr(),
                           data.data_ptr(), scan_int.data_ptr(), near,
                           partial.data_ptr(), carry, base_p, t, s, nz, n,
                           nmodes, nprb, ndet, model_code, int(prefetch), g0,
                           g1, first, last, grid, threads)
        else:
            _launch.launch(name, "tk_grad_fused", dev, psi.data_ptr(),
                           prb.data_ptr(), data.data_ptr(),
                           scan_int.data_ptr(), near, scratch.data_ptr(),
                           partial.data_ptr(), carry, base_p, t, s, nz, n,
                           nmodes, nprb, ndet, model_code, g0, g1, first,
                           last, grid)
        grad_fused.body_launches[body] += 1

    grad = _scan_order(grad_fused, launch, prb, scan_int, t, s, nz, n, chunk,
                       grid, threads, psi.device)
    if t * s == 0:
        partial.zero_()
    grad_fused.variant = variant
    grad_fused.body = body
    return grad, partial.sum().to(torch.float32)


def _minf_fused_cuda(psi, data, scan_int, prb, ndet, model, base,
                     variant=None):
    """Launches ``minf_fused``'s kernel; ``variant``, the body and the
    prefetch as in :func:`_grad_fused_cuda` (``variant='fft_smem'`` forces
    the shared-memory body where the fused one would run). Each launch adds
    one to ``minf_fused.launches`` and to its body's count in
    ``minf_fused.body_launches``."""
    name = "minf_fused"
    t, nz, n, nmodes, nprb, s = _check_inputs(name, psi, scan_int, prb,
                                              ndet, data)
    base_p = _base_ptr(name, base, (t, s, nmodes, ndet, ndet), psi.device)
    variant, body = _pick_body(name, variant, nprb, ndet, nmodes)
    dev = _launch.device_index(psi)
    psi, prb = psi.contiguous(), prb.contiguous()
    data, scan_int = data.contiguous(), scan_int.contiguous()
    model_code = _launch.MODEL_CODE[model]
    if variant == "fft":
        prefetch = _fft_prefetch(nmodes, data)
        grid = _launch.fft_grid(name, dev, t * s, ndet,
                                int(nmodes > 1 or prefetch), base is not None,
                                body)
        partial = torch.empty(grid, dtype=torch.float64, device=psi.device)
        _launch.launch(name, _launch.fft_entry(name, body), dev,
                       psi.data_ptr(), prb.data_ptr(), data.data_ptr(),
                       scan_int.data_ptr(), partial.data_ptr(), base_p, t, s,
                       nz, n, nmodes, nprb, ndet, model_code, int(prefetch),
                       grid, fft_threads(ndet))
    else:
        stride = 2 * nprb * ndet + ndet * ndet  # floats: p x d complex, d x d
        stride += stride % 2
        grid = _launch.gemm_grid(name, dev, t * s, ndet, base is not None,
                                 4 * stride)
        scratch = torch.empty(grid * stride, dtype=torch.float32,
                              device=psi.device)
        partial = torch.empty(grid, dtype=torch.float64, device=psi.device)
        _launch.launch(name, "tk_minf_fused", dev, psi.data_ptr(),
                       prb.data_ptr(), data.data_ptr(), scan_int.data_ptr(),
                       scratch.data_ptr(), partial.data_ptr(), base_p, t, s,
                       nz, n, nmodes, nprb, ndet, model_code, grid, stride)
    minf_fused.launches += 1
    minf_fused.body_launches[body] += 1
    minf_fused.variant = variant
    minf_fused.body = body
    return partial.sum().to(torch.float32)


def _fwd_cuda(psi, scan_int, prb, ndet, base, variant=None):
    """Launches ``fwd``'s kernel; ``variant`` as in
    :func:`_grad_fused_cuda`. The output comes from ``torch.empty``, so it is
    aligned for the 'fft' variant's 16-byte stores, and the kernel writes
    every frame of it (masked ones as zeros or the base)."""
    name = "fwd"
    t, nz, n, nmodes, nprb, s = _check_inputs(name, psi, scan_int, prb, ndet)
    shape = (t, s, nmodes, ndet, ndet)
    base_p = _base_ptr(name, base, shape, psi.device)
    variant = _pick_variant(name, variant, nprb, ndet, nmodes)
    dev = _launch.device_index(psi)
    psi, prb = psi.contiguous(), prb.contiguous()
    scan_int = scan_int.contiguous()
    out = torch.empty(shape, dtype=torch.complex64, device=psi.device)
    if variant == "fft":
        # The base is read 8 bytes at a time: any complex64 tensor will do,
        # such as a streamed chunk's slice of the whole base (which starts
        # at a whole frame, so it would stay 16-byte aligned anyway).
        grid = _launch.fft_grid(name, dev, t * s, ndet, 0, base is not None)
        _launch.launch(name, "tk_fwd_fft", dev, psi.data_ptr(),
                       prb.data_ptr(), scan_int.data_ptr(), out.data_ptr(),
                       base_p, t, s, nz, n, nmodes, nprb, ndet, grid,
                       fft_threads(ndet))
    else:
        grid = _launch.gemm_grid(name, dev, t * s, ndet, base is not None,
                                 8 * nprb * ndet)
        scratch = torch.empty(2 * grid * nprb * ndet, dtype=torch.float32,
                              device=psi.device)
        _launch.launch(name, "tk_fwd", dev, psi.data_ptr(), prb.data_ptr(),
                       scan_int.data_ptr(), out.data_ptr(),
                       scratch.data_ptr(), base_p, t, s, nz, n, nmodes, nprb,
                       ndet, grid)
    fwd.launches += 1
    fwd.variant = variant
    return out


def _grad_prb_fused_cuda(psi, data, scan_int, prb, ndet, model,
                         variant=None):
    """Launches ``grad_prb_fused``'s kernel; ``variant`` and the prefetch
    as in :func:`_grad_fused_cuda`."""
    name = "grad_prb_fused"
    t, nz, n, nmodes, nprb, s = _check_inputs(name, psi, scan_int, prb,
                                              ndet, data)
    variant = _pick_variant(name, variant, nprb, ndet, nmodes)
    dev = _launch.device_index(psi)
    acc_block = t * nmodes * nprb * nprb       # complex elements
    psi, prb = psi.contiguous(), prb.contiguous()
    data, scan_int = data.contiguous(), scan_int.contiguous()
    grad = torch.empty((t, nmodes, nprb, nprb), dtype=torch.complex64,
                       device=psi.device)
    model_code = _launch.MODEL_CODE[model]
    if variant == "fft":
        prefetch = _fft_prefetch(nmodes, data)
        grid = min(_launch.fft_grid(name, dev, t * s, ndet,
                                    int(nmodes > 1 or prefetch), False),
                   max(1, _launch.SCRATCH_BYTES // (8 * acc_block)))
        acc = torch.empty(2 * grid * acc_block, dtype=torch.float32,
                          device=psi.device)
        partial = torch.empty(grid, dtype=torch.float64, device=psi.device)
        _launch.launch(name, "tk_grad_prb_fused_fft", dev, psi.data_ptr(),
                       prb.data_ptr(), data.data_ptr(), scan_int.data_ptr(),
                       grad.data_ptr(), acc.data_ptr(), partial.data_ptr(), t,
                       s, nz, n, nmodes, nprb, ndet, model_code,
                       int(prefetch), grid, fft_threads(ndet))
    else:
        per_block = nmodes * ndet * (nprb + ndet)  # complex elements
        grid = _launch.gemm_grid(name, dev, t * s, ndet, False,
                                 8 * (per_block + acc_block))
        acc = torch.empty(2 * grid * acc_block, dtype=torch.float32,
                          device=psi.device)
        scratch = torch.empty(2 * grid * per_block, dtype=torch.float32,
                              device=psi.device)
        partial = torch.empty(grid, dtype=torch.float64, device=psi.device)
        _launch.launch(name, "tk_grad_prb_fused", dev, psi.data_ptr(),
                       prb.data_ptr(), data.data_ptr(), scan_int.data_ptr(),
                       grad.data_ptr(), acc.data_ptr(), scratch.data_ptr(),
                       partial.data_ptr(), t, s, nz, n, nmodes, nprb, ndet,
                       model_code, grid)
    grad_prb_fused.launches += 1
    grad_prb_fused.variant = variant
    return grad, partial.sum().to(torch.float32)


def _adj_cuda(farplane, scan_int, prb, nz, n, variant=None, chunk=None):
    """Launches ``adj``'s kernels: for each chunk of ``chunk`` positions
    (default :func:`adj_chunk`), the frame kernel ('fft' or 'gemm', forced
    or picked as in :func:`_grad_fused_cuda`) into the scratch, then
    ``scatter_conj_probe``'s tile kernel from it into the object,
    continuing from the running sums of the chunk before.
    ``variant='atomic'`` forces
    the one-pass FFT kernel with fp32 atomics that this design replaced
    (FFT sizes only), to time the two in turns. Each frame-kernel launch
    adds one to ``adj.launches``."""
    name = "adj"
    t, s, nmodes, ndet = _check_farplane(name, farplane, scan_int, prb,
                                         "prb", (farplane.shape[0],
                                                 farplane.shape[2]))
    nprb = prb.shape[-1]
    atomic = variant == "atomic"
    variant = _pick_variant(name, "fft" if atomic else variant, nprb, ndet,
                            nmodes)
    chunk = adj_chunk(t, s, nmodes, nprb) if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"adj: chunk must be >= 1, got {chunk}")
    chunk = min(chunk, max(s, 1))
    dev = _launch.device_index(farplane)
    # The streamed gradient pass hands over each chunk's residual, a new
    # contiguous tensor: no copy here.
    farplane, prb = farplane.contiguous(), prb.contiguous()
    scan_int = scan_int.contiguous()
    if variant == "fft":
        _check_aligned(name, farplane)
        threads = fft_threads(ndet)
    if atomic:
        out = torch.zeros((t, nz, n), dtype=torch.complex64,
                          device=farplane.device)
        grid = _launch.fft_grid(name, dev, t * s, ndet, 0, False)
        _launch.launch(name, "tk_adj_atomic_fft", dev, farplane.data_ptr(),
                       prb.data_ptr(), scan_int.data_ptr(), out.data_ptr(), t,
                       s, nz, n, nmodes, nprb, ndet, grid, threads)
        adj.launches += 1
        adj.variant = "atomic"
        return out
    # Every pixel is stored by the last tile launch, covered or not; the
    # chunks before it keep their running sums in double.
    out = torch.empty((t, nz, n), dtype=torch.complex64,
                      device=farplane.device)
    running = (torch.empty((t, nz, n), dtype=torch.complex128,
                           device=farplane.device) if chunk < s else None)
    scratch = torch.empty(t * chunk * nmodes * nprb * nprb,
                          dtype=torch.complex64, device=farplane.device)
    if variant == "gemm":
        grid = _launch.gemm_grid(name, dev, t * chunk, ndet, False,
                                 8 * nprb * ndet)
        block_scratch = torch.empty(2 * grid * nprb * ndet,
                                    dtype=torch.float32,
                                    device=farplane.device)
    boxes = kernels.scatter_boxes(scan_int, nz, n, nprb)
    for c0 in range(0, max(s, 1), chunk):
        sc = min(chunk, s - c0)
        far_c = farplane[:, c0:c0 + sc]
        scan_c = scan_int[:, c0:c0 + sc].contiguous()
        near = scratch[:t * sc * nmodes * nprb * nprb].view(
            t, sc, nmodes, nprb, nprb)
        if variant == "fft":
            grid = _launch.fft_grid(name, dev, t * sc, ndet, 0, False)
            _launch.launch(name, "tk_adj_fft", dev, far_c.data_ptr(),
                           scan_c.data_ptr(), near.data_ptr(), t, sc, nz, n,
                           nmodes, nprb, ndet, farplane.stride(0), grid,
                           threads)
        else:
            _launch.launch(name, "tk_adj", dev, far_c.data_ptr(),
                           scan_c.data_ptr(), near.data_ptr(),
                           block_scratch.data_ptr(), t, sc, nz, n, nmodes,
                           nprb, ndet, farplane.stride(0), grid)
        adj.launches += 1
        kernels._scatter_conj_probe_cuda(near, scan_c, prb, nz, n, out=out,
                                         partial=running,
                                         from_partial=c0 > 0,
                                         last=c0 + sc == s, boxes=boxes,
                                         first=c0)
    adj.variant = variant
    return out


def _adj_probe_cuda(farplane, scan_int, psi, nprb, variant=None):
    """Launches ``adj_probe``'s kernel; ``variant`` as in
    :func:`_grad_fused_cuda`."""
    name = "adj_probe"
    t, s, nmodes, ndet = _check_farplane(name, farplane, scan_int, psi,
                                         "psi", (farplane.shape[0],))
    _, nz, n = psi.shape
    variant = _pick_variant(name, variant, nprb, ndet, nmodes)
    dev = _launch.device_index(farplane)
    acc_block = t * nmodes * nprb * nprb  # complex elements
    farplane, psi = farplane.contiguous(), psi.contiguous()
    scan_int = scan_int.contiguous()
    out = torch.empty((t, nmodes, nprb, nprb), dtype=torch.complex64,
                      device=farplane.device)
    if variant == "fft":
        _check_aligned(name, farplane)
        grid = min(_launch.fft_grid(name, dev, t * s, ndet, 0, False),
                   max(1, _launch.SCRATCH_BYTES // (8 * acc_block)))
        acc = torch.empty(2 * grid * acc_block, dtype=torch.float32,
                          device=farplane.device)
        _launch.launch(name, "tk_adj_probe_fft", dev, farplane.data_ptr(),
                       psi.data_ptr(), scan_int.data_ptr(), out.data_ptr(),
                       acc.data_ptr(), t, s, nz, n, nmodes, nprb, ndet, grid,
                       fft_threads(ndet))
    else:
        grid = _launch.gemm_grid(name, dev, t * s, ndet, False,
                                 8 * (nprb * ndet + acc_block))
        acc = torch.empty(2 * grid * acc_block, dtype=torch.float32,
                          device=farplane.device)
        scratch = torch.empty(2 * grid * nprb * ndet, dtype=torch.float32,
                              device=farplane.device)
        _launch.launch(name, "tk_adj_probe", dev, farplane.data_ptr(),
                       psi.data_ptr(), scan_int.data_ptr(), out.data_ptr(),
                       acc.data_ptr(), scratch.data_ptr(), t, s, nz, n,
                       nmodes, nprb, ndet, grid)
    adj_probe.launches += 1
    adj_probe.variant = variant
    return out


def _adj_residual_cuda(farplane, data, scan_int, prb, nz, n, model,
                       variant=None, chunk=None):
    """Launches ``adj_residual``'s kernels as :func:`_grad_fused_cuda`
    launches ``grad_fused``'s: the frame kernel on each chunk of ``chunk``
    frames, then the tile kernel; ``variant`` (``'atomic'`` included)
    likewise. Each frame-kernel launch adds one to
    ``adj_residual.launches``."""
    name = "adj_residual"
    t, s, nmodes, ndet = _check_farplane(name, farplane, scan_int, prb,
                                         "prb", (farplane.shape[0],
                                                 farplane.shape[2]))
    _launch.check_types(name, {"farplane": (farplane, torch.complex64),
                               "data": (data, torch.float32)})
    if data.shape != (t, s, ndet, ndet):
        raise ValueError(f"adj_residual: inconsistent shapes farplane "
                         f"{tuple(farplane.shape)}, data {tuple(data.shape)}")
    nprb = prb.shape[-1]
    atomic = variant == "atomic"
    variant = _pick_variant(name, "fft" if atomic else variant, nprb, ndet,
                            nmodes)
    chunk = _chunk_arg(name, chunk, nmodes, nprb)
    dev = _launch.device_index(farplane)
    farplane, prb = farplane.contiguous(), prb.contiguous()
    data, scan_int = data.contiguous(), scan_int.contiguous()
    if variant == "fft":
        # The materialized solver hands over fwd's output, which PyTorch's
        # allocator aligns.
        _check_aligned(name, farplane)
        threads = fft_threads(ndet)
        grid = _launch.fft_grid(name, dev, t * s, ndet, int(nmodes > 1),
                                False)
    else:
        stride = 2 * nprb * ndet + ndet * ndet  # floats: p x d complex, d x d
        stride += stride % 2
        grid = _launch.gemm_grid(name, dev, t * s, ndet, False, 4 * stride)
        scratch = torch.empty(grid * stride, dtype=torch.float32,
                              device=farplane.device)
        threads = _GEMM_THREADS
    partial = torch.empty(grid, dtype=torch.float64, device=farplane.device)
    model_code = _launch.MODEL_CODE[model]
    if atomic:
        grad = torch.zeros((t, nz, n), dtype=torch.complex64,
                           device=farplane.device)
        _launch.launch(name, "tk_adj_residual_atomic_fft", dev,
                       farplane.data_ptr(), data.data_ptr(), prb.data_ptr(),
                       scan_int.data_ptr(), grad.data_ptr(),
                       partial.data_ptr(), t, s, nz, n, nmodes, nprb, ndet,
                       model_code, grid, threads)
        adj_residual.launches += 1
        adj_residual.variant = "atomic"
        return grad, partial.sum().to(torch.float32)

    def launch(g0, g1, first, last, near, carry):
        if variant == "fft":
            _launch.launch(name, "tk_adj_residual_fft", dev,
                           farplane.data_ptr(), data.data_ptr(),
                           scan_int.data_ptr(), near, partial.data_ptr(),
                           carry, t, s, nz, n, nmodes, nprb, ndet, model_code,
                           g0, g1, first, last, grid, threads)
        else:
            _launch.launch(name, "tk_adj_residual", dev, farplane.data_ptr(),
                           data.data_ptr(), scan_int.data_ptr(), near,
                           scratch.data_ptr(), partial.data_ptr(), carry, t,
                           s, nz, n, nmodes, nprb, ndet, model_code, g0, g1,
                           first, last, grid, stride)

    grad = _scan_order(adj_residual, launch, prb, scan_int, t, s, nz, n,
                       chunk, grid, threads, farplane.device)
    if t * s == 0:
        partial.zero_()
    adj_residual.variant = variant
    return grad, partial.sum().to(torch.float32)


def _fwd_quad_stats_cuda(dpsi, scan_int, prb, fpsi, variant=None):
    """Launches ``fwd_quad_stats``' kernel; ``variant`` as in
    :func:`_grad_fused_cuda`."""
    name = "fwd_quad_stats"
    t, s, nmodes, ndet = _check_farplane(name, fpsi, scan_int, prb, "prb",
                                         (fpsi.shape[0], fpsi.shape[2]))
    _, nz, n, _, nprb, _ = _check_inputs(name, dpsi, scan_int, prb, ndet)
    variant = _pick_variant(name, variant, nprb, ndet, nmodes)
    dev = _launch.device_index(fpsi)
    dpsi, prb = dpsi.contiguous(), prb.contiguous()
    fpsi, scan_int = fpsi.contiguous(), scan_int.contiguous()
    a, b, c = torch.empty((3, t, s, ndet, ndet), dtype=torch.float32,
                          device=fpsi.device)
    if variant == "fft":
        # The materialized solver hands over fwd's output, which PyTorch's
        # allocator aligns.
        _check_aligned(name, fpsi)
        grid = _launch.fft_grid(name, dev, t * s, ndet, 0, False)
        _launch.launch(name, "tk_fwd_quad_stats_fft", dev, dpsi.data_ptr(),
                       prb.data_ptr(), scan_int.data_ptr(), fpsi.data_ptr(),
                       a.data_ptr(), b.data_ptr(), c.data_ptr(), t, s, nz, n,
                       nmodes, nprb, ndet, grid, fft_threads(ndet))
    else:
        grid = _launch.gemm_grid(name, dev, t * s, ndet, False,
                                 8 * nprb * ndet)
        scratch = torch.empty(2 * grid * nprb * ndet, dtype=torch.float32,
                              device=fpsi.device)
        _launch.launch(name, "tk_fwd_quad_stats", dev, dpsi.data_ptr(),
                       prb.data_ptr(), scan_int.data_ptr(), fpsi.data_ptr(),
                       a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       scratch.data_ptr(), t, s, nz, n, nmodes, nprb, ndet,
                       grid)
    fwd_quad_stats.launches += 1
    fwd_quad_stats.variant = variant
    return a, b, c
