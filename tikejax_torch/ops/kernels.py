"""The hybrid tier's patch kernels: the hand-written ``gather_probe_mul``,
``scatter_conj_probe`` and ``adj_probe_reduce``.

Counterpart of ``tikejax.ops.pallas_kernels`` (same three functions, same
argument order). They are the operators of ``kernel='pallas'`` with the FFT
left to the library (cuFFT through ``torch.fft``, as the JAX package leaves
it to XLA's FFT outside any Pallas kernel):

* :func:`gather_probe_mul` -- forward, before the FFT: gather the object
  patch of every scan position and multiply it by every probe mode;
* :func:`scatter_conj_probe` -- object adjoint, after the inverse FFT:
  conj-probe multiply, mode sum and overlap scatter-add into the object;
* :func:`adj_probe_reduce` -- probe adjoint, after the inverse FFT: gather
  the object patches, conj-multiply with the frames and sum over the
  positions.

A position whose scan row is < 0 is a masked dummy: its gathered frames are
zero and it adds nothing to either adjoint.

The CUDA sources are ``tikejax_torch/csrc/gather_probe_mul.cu``,
``scatter_conj_probe.cu`` and ``adj_probe_reduce.cu`` (built by
``tikejax_torch.utils.cuda_build``); their notes say what bounds each on an
H100 (the one pass over the nearplane). ``gather_probe_mul`` launches a
persistent kernel built to write at that bound: a thread owns fixed pixel
pairs of the patch (pixels at an odd ``nprb``) for every frame, holds
their probe values in registers, reads the object 16 bytes a pair where the
patch corner is aligned and writes with 16-byte streaming stores. The
one-block-per-frame kernel it replaced stays only for timing the two in
turns, forced with ``_gather_probe_mul_cuda(..., variant='pixel')``; the
two write the same bits (``gather_probe_mul.variant`` names the last
launch's). The TPU kernels' addressing scheme
(aligned power-of-two windows, object padding, sublane/lane rotates, split
re/im planes) serves Mosaic's alignment rules and is not carried over. The
kernels take complex64 and int32 only. The two adjoints read their frames
in place through the tensor's strides (the innermost must be 1), because
their caller hands them ``crop_from_det(ifft2o(farplane), nprb)``, a strided
view whenever ``ndet > nprb``: a contiguous copy would be one more pass over
all frames.

Determinism: all three are bitwise repeatable. ``scatter_conj_probe``
launches a tile-owned kernel: a block owns a tile of the object and sums,
in registers, the contributions of the positions whose windows cover it in
increasing scan order -- the TPU kernel's order -- and stores each pixel
once, with no atomics (:func:`scatter_tile_plan` cuts the object into its
tiles). The fp32-atomic kernel it replaced, deterministic only up to the
order in which overlapping patches land, stays only for timing the two in
turns, forced with ``_scatter_conj_probe_cuda(..., variant='atomic')``
(``scatter_conj_probe.variant`` names the last launch's). The tile kernel
sums each pixel in double and rounds it to fp32 once; it can also leave its
running sums in double and continue from them, which is how the fused
tiers' object scatters (``adj``, ``grad_fused``, ``adj_residual``) sum
their frames chunk by chunk with the bits of one pass.
``gather_probe_mul`` has no reduction, and ``adj_probe_reduce`` sums fixed
runs of positions in registers and the runs in a fixed order.

Each function takes CPU or CUDA tensors. On a CUDA tensor it launches its
kernel or raises; on a CPU tensor it runs its ``*_reference``, the plain
PyTorch version (the oracle operators' few lines), which also takes
complex128. Each keeps an integer count of its runs in its ``launches``
attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tikejax_torch.ops import fused
from tikejax_torch.ops import patches as _patches
from tikejax_torch.utils import cuda_build, profiling

# adj_probe_reduce cuts the positions of an angle into runs so that about
# this many blocks are in flight (132 SMs x 8 blocks of 256 threads, twice).
_TARGET_BLOCKS = 2048
_MAX_GRID_YZ = 65535
# scatter_conj_probe's tile kernel: 256 threads own a tile of the object,
# SCATTER_TILE = (rows, columns) pixels, one pixel a thread (the shape
# csrc/scatter_conj_probe.cu is built for), one block per (angle, tile).
SCATTER_TILE = (8, 32)
# The tile kernel walks an angle's scan in chunks of this many consecutive
# positions (one a thread); scatter_box_plan boxes each chunk.
SCATTER_CHUNK = 256
_MAX_GRID_X = 2**31 - 1
# An empty chunk's box: no tile meets it.
_NO_BOX = (2**30, 2**30, -2**30, -2**30)


def gather_probe_mul(psi: torch.Tensor, scan_int: torch.Tensor,
                     prb: torch.Tensor) -> torch.Tensor:
    """Fused gather+multiply: ``nearplane[t, s, m] = psi[patch(s)] *
    prb[m]``; zero frames for a masked position (scan row < 0).

    Args:
      psi: ``(ntheta, nz, n)`` complex object.
      scan_int: ``(ntheta, nscan, 2)`` int32 (y, x) offsets.
      prb: ``(ntheta, nmodes, nprb, nprb)`` complex probe.

    Returns:
      ``(ntheta, nscan, nmodes, nprb, nprb)`` like ``psi``.
    """
    if not fused._route("gather_probe_mul", psi):
        return gather_probe_mul_reference(psi, scan_int, prb)
    return _gather_probe_mul_cuda(psi, scan_int, prb)


gather_probe_mul.launches = 0
gather_probe_mul.variant = None  # of the last launch: 'persistent' or 'pixel'


def gather_probe_mul_reference(psi: torch.Tensor, scan_int: torch.Tensor,
                               prb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_probe_mul`, on any device."""
    gather_probe_mul_reference.launches += 1
    patches = _patches.gather_patches(psi, scan_int, prb.shape[-1])
    return patches[:, :, None] * prb[:, None]


gather_probe_mul_reference.launches = 0


def scatter_conj_probe(nearplane: torch.Tensor, scan_int: torch.Tensor,
                       prb: torch.Tensor, nz: int, n: int) -> torch.Tensor:
    """Adjoint-to-object accumulation: ``psi_acc[patch(s)] += sum_m
    conj(prb[m]) * nearplane[s, m]``; a masked position adds nothing.

    Args:
      nearplane: ``(ntheta, nscan, nmodes, nprb, nprb)`` complex frames
        (inverse-FFT'd and cropped; any strides with the innermost 1).

    Returns:
      ``(ntheta, nz, n)`` like ``nearplane``.
    """
    if not fused._route("scatter_conj_probe", nearplane):
        return scatter_conj_probe_reference(nearplane, scan_int, prb, nz, n)
    return _scatter_conj_probe_cuda(nearplane, scan_int, prb, nz, n)


scatter_conj_probe.launches = 0
scatter_conj_probe.variant = None  # of the last launch: 'tile' or 'atomic'


def scatter_conj_probe_reference(nearplane: torch.Tensor,
                                 scan_int: torch.Tensor, prb: torch.Tensor,
                                 nz: int, n: int,
                                 out: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_conj_probe`, on any device.
    With ``out`` (a partial object from the positions before these) it
    adds into ``out`` and returns it: on the CPU each pixel continues in
    scan order, so chunk after chunk gives the bits of one call."""
    scatter_conj_probe_reference.launches += 1
    patches = torch.sum(torch.conj(prb)[:, None] * nearplane, dim=2)
    return _patches.scatter_patches_add(patches, scan_int, nz, n, out=out)


scatter_conj_probe_reference.launches = 0


def adj_probe_reduce(nearplane: torch.Tensor, scan_int: torch.Tensor,
                     psi: torch.Tensor) -> torch.Tensor:
    """Probe adjoint: ``prb_acc[m] = sum_s conj(psi[patch(s)]) *
    nearplane[s, m]``; a masked position adds nothing. ``nearplane`` as in
    :func:`scatter_conj_probe`.

    Returns:
      ``(ntheta, nmodes, nprb, nprb)`` like ``nearplane``.
    """
    if not fused._route("adj_probe_reduce", nearplane):
        return adj_probe_reduce_reference(nearplane, scan_int, psi)
    return _adj_probe_reduce_cuda(nearplane, scan_int, psi)


adj_probe_reduce.launches = 0


def adj_probe_reduce_reference(nearplane: torch.Tensor,
                               scan_int: torch.Tensor,
                               psi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`adj_probe_reduce`, on any device."""
    adj_probe_reduce_reference.launches += 1
    patches = _patches.gather_patches(psi, scan_int, nearplane.shape[-1])
    return torch.sum(torch.conj(patches)[:, :, None] * nearplane, dim=1)


adj_probe_reduce_reference.launches = 0


# -- the CUDA path -------------------------------------------------------

_STRIDES = [ctypes.c_int64] * 4
_GATHER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
_SCATTER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + _STRIDES
_TILE_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + _STRIDES
# Argument types of each entry point of a library: pointers, ints (and the
# frames' four strides), then the stream.
_ENTRIES = {
    "gather_probe_mul": {"tk_gather_probe_mul": _GATHER_ARGS,
                         "tk_gather_probe_mul_pixel": _GATHER_ARGS},
    "scatter_conj_probe": {
        # + tiles_y, tiles_x, mode_chunk, from_partial, box_chunks, first
        "tk_scatter_conj_probe": _TILE_ARGS + [ctypes.c_int] * 6,
        "tk_scatter_conj_probe_atomic": _SCATTER_ARGS},
    "adj_probe_reduce": {"tk_adj_probe_reduce": [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 7 + _STRIDES},
}


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    for symbol, argtypes in _ENTRIES[name].items():
        entry = getattr(lib, symbol)
        entry.argtypes = argtypes + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
    lib.tk_error_string.argtypes = [ctypes.c_int]
    lib.tk_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, device_index: int, *args, entry=None) -> None:
    """Call ``tk_<name>(*args, stream)`` (or the library's ``entry``) on the
    current stream of the device; raise on a refused launch."""
    lib = _lib(name)
    with torch.cuda.device(device_index):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry or f"tk_{name}")(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.tk_error_string(err).decode()}")


def _check_frames(name, nearplane, scan_int, other, other_name):
    """Checks of the adjoints' inputs: ``nearplane`` (t, s, m, p, p) with
    innermost stride 1, ``scan_int`` (t, s, 2) and ``other`` (the probe
    (t, m, p, p) or the object (t, nz, n)); returns (t, s, m, p)."""
    t, s, m, p, p2 = nearplane.shape
    fused._check_types(name, {"nearplane": (nearplane, torch.complex64),
                              other_name: (other, torch.complex64),
                              "scan_int": (scan_int, torch.int32)})
    lead = (t, m, p, p) if other_name == "prb" else (t,)
    if (p2 != p or scan_int.shape != (t, s, 2)
            or tuple(other.shape[:len(lead)]) != lead):
        raise ValueError(
            f"{name}: inconsistent shapes nearplane "
            f"{tuple(nearplane.shape)}, {other_name} {tuple(other.shape)}, "
            f"scan_int {tuple(scan_int.shape)}")
    if nearplane.numel() and nearplane.stride(-1) != 1:
        raise ValueError(
            f"{name}: the kernel reads the frames in place and needs their "
            f"innermost stride to be 1, got strides {nearplane.stride()}")
    return t, s, m, p


def _gather_variant(variant):
    """The kernel to launch: the persistent one, unless ``'pixel'`` forces
    the one it replaced; anything else raises before any launch."""
    if variant is None:
        return "persistent"
    if variant != "pixel":
        raise ValueError(f"gather_probe_mul: unknown variant {variant!r}; "
                         "expected 'pixel' or None")
    return variant


def _gather_probe_mul_cuda(psi, scan_int, prb, variant=None):
    """Launches ``gather_probe_mul``'s persistent kernel, or the pixel
    kernel it replaced when ``variant='pixel'`` forces it (to time the two
    in turns); both write the same bits."""
    name = "gather_probe_mul"
    variant = _gather_variant(variant)
    t, nz, n = psi.shape
    _, m, p, p2 = prb.shape
    s = scan_int.shape[1]
    fused._check_types(name, {"psi": (psi, torch.complex64),
                              "prb": (prb, torch.complex64),
                              "scan_int": (scan_int, torch.int32)})
    if prb.shape[0] != t or p2 != p or scan_int.shape != (t, s, 2):
        raise ValueError(
            f"{name}: inconsistent shapes psi {tuple(psi.shape)}, prb "
            f"{tuple(prb.shape)}, scan_int {tuple(scan_int.shape)}")
    out = torch.empty((t, s, m, p, p), dtype=torch.complex64,
                      device=psi.device)
    psi, prb, scan_int = psi.contiguous(), prb.contiguous(), (
        scan_int.contiguous())
    if scan_int.data_ptr() % 8:  # read a position (8 bytes) at a time
        scan_int = scan_int.clone()
    # The persistent kernel reads object pixel pairs 16 bytes at a time
    # where the patch corner allows it: only in an aligned object of even
    # row length.
    vec = int(psi.data_ptr() % 16 == 0 and n % 2 == 0)
    _launch(name, fused._device_index(psi), psi.data_ptr(), prb.data_ptr(),
            scan_int.data_ptr(), out.data_ptr(), t, s, nz, n, m, p, vec,
            entry=("tk_gather_probe_mul_pixel" if variant == "pixel"
                   else None))
    gather_probe_mul.launches += 1
    gather_probe_mul.variant = variant
    return out


def scatter_tile_plan(t: int, nz: int, n: int):
    """How ``scatter_conj_probe``'s tile kernel cuts ``t`` objects of
    ``nz x n`` pixels into tiles of ``SCATTER_TILE`` pixels:
    ``(tiles_y, tiles_x, blocks)``, the tiles along each axis (the last
    ones partial where the tile does not divide the side) and one block per
    (angle, tile). Raises where the blocks pass the grid's limit. Pure: no
    device is involved."""
    tiles_y, tiles_x = -(-nz // SCATTER_TILE[0]), -(-n // SCATTER_TILE[1])
    blocks = t * tiles_y * tiles_x
    if blocks > _MAX_GRID_X:
        raise ValueError(f"scatter_conj_probe: {blocks} tiles pass the "
                         f"grid's limit of {_MAX_GRID_X} blocks")
    return tiles_y, tiles_x, blocks


def scatter_box_plan(scan_int: torch.Tensor, nz: int, n: int,
                     nprb: int) -> torch.Tensor:
    """The tile kernel's chunk boxes of a scan: for each angle and each
    chunk of ``SCATTER_CHUNK`` consecutive positions (positions ``[c C, c
    C + C)``), the least and the greatest corner of its valid positions
    (those whose window lies in the ``nz x n`` object; masked rows are not
    valid), ``(ymin, xmin, ymax, xmax)``; a chunk with none gets a box that
    meets no tile. Returns ``(t, ceil(s / C), 4)`` int32 on the scan's
    device (pure PyTorch). A tile ``[y0, y1) x [x0, x1)`` can meet a window
    of the chunk only if ``ymin < y1``, ``ymax + nprb > y0``, ``xmin < x1``
    and ``xmax + nprb > x0``; the kernel skips a chunk that fails it."""
    t, s, _ = scan_int.shape
    chunks = -(-s // SCATTER_CHUNK)
    masked = scan_int.new_full((t, chunks * SCATTER_CHUNK - s, 2), -1)
    sc = torch.cat([scan_int, masked], dim=1).view(t, chunks, SCATTER_CHUNK,
                                                   2)
    y, x = sc[..., 0], sc[..., 1]
    valid = (y >= 0) & (y <= nz - nprb) & (x >= 0) & (x <= n - nprb)
    lo, hi = (torch.tensor(v, dtype=scan_int.dtype, device=scan_int.device)
              for v in (_NO_BOX[0], _NO_BOX[2]))
    return torch.stack([torch.where(valid, y, lo).amin(-1),
                        torch.where(valid, x, lo).amin(-1),
                        torch.where(valid, y, hi).amax(-1),
                        torch.where(valid, x, hi).amax(-1)],
                       dim=-1).to(torch.int32)


def scatter_boxes(scan_int: torch.Tensor, nz: int, n: int,
                  nprb: int) -> torch.Tensor:
    """:func:`scatter_box_plan` of ``scan_int``, made once and kept on the
    scan tensor itself (a solve hands the same scan to every evaluation);
    made again if the scan was changed in place or the shapes differ. Each
    plan made is an ``ops.scan_plan`` span."""
    key = (scan_int.data_ptr(), scan_int._version, nz, n, nprb)
    held = getattr(scan_int, "_tk_scatter_boxes", None)
    if held is None or held[0] != key:
        with profiling.span("ops.scan_plan"):
            held = (key, scatter_box_plan(scan_int, nz, n, nprb))
        scan_int._tk_scatter_boxes = held
    return held[1]


def scatter_mode_chunk(nmodes: int) -> int:
    """How many modes of a position the tile kernel loads at once: 1, 2
    or 4 (three modes take a chunk of 4 with one left empty, more than
    four several chunks); a thread keeps 12 pixel loads in flight whatever
    the number of modes."""
    return 1 if nmodes <= 1 else 2 if nmodes == 2 else 4


def _scatter_variant(variant):
    """The kernel to launch: the tile kernel, unless ``'atomic'`` forces
    the one it replaced; anything else raises before any launch."""
    if variant is None:
        return "tile"
    if variant != "atomic":
        raise ValueError(f"scatter_conj_probe: unknown variant {variant!r}; "
                         "expected 'atomic' or None")
    return variant


def scatter_blocks_per_sm(device_index: int, nmodes: int = 1) -> int:
    """Resident blocks per SM of the tile kernel's instantiation for
    ``nmodes`` modes."""
    per_sm = ctypes.c_int(0)
    lib = _lib("scatter_conj_probe")
    with torch.cuda.device(device_index):
        err = lib.tk_scatter_conj_probe_blocks_per_sm(
            scatter_mode_chunk(nmodes), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"scatter_conj_probe: occupancy query failed: "
                           f"{lib.tk_error_string(err).decode()}")
    return per_sm.value


def _scatter_conj_probe_cuda(nearplane, scan_int, prb, nz, n, variant=None,
                             out=None, partial=None, from_partial=False,
                             last=True, boxes=None, first=0, skip=True):
    """Launches ``scatter_conj_probe``'s tile kernel, or the atomic kernel
    it replaced when ``variant='atomic'`` forces it (to time the two in
    turns). The tile kernel sums each pixel in double. With ``last`` (the
    default) it rounds the sums into ``out`` (a contiguous complex64 ``(t,
    nz, n)``, made when not given) and returns it; without, it stores them
    into ``partial`` (a contiguous complex128 ``(t, nz, n)``) and returns
    that. With ``from_partial`` each pixel continues from the sum
    ``partial`` holds: the fused tiers' object scatters sum their chunks of
    positions so, with the bits of one launch.

    The tile kernel skips the chunks of positions whose box misses its
    tile: ``boxes`` are :func:`scatter_box_plan`'s of the angles' whole
    scan, of which ``scan_int`` holds positions ``[first, first + s)``
    (None: :func:`scatter_boxes` of ``scan_int``, ``first`` 0).
    ``skip=False`` walks every chunk; the bits are the same."""
    name = "scatter_conj_probe"
    variant = _scatter_variant(variant)
    t, s, m, p = _check_frames(name, nearplane, scan_int, prb, "prb")
    prb, scan_int = prb.contiguous(), scan_int.contiguous()
    if variant == "atomic":
        out = torch.zeros((t, nz, n), dtype=torch.complex64,
                          device=nearplane.device)
        _launch(name, fused._device_index(nearplane), nearplane.data_ptr(),
                prb.data_ptr(),
                scan_int.data_ptr(), out.data_ptr(), t, s, nz, n, m, p,
                *nearplane.stride()[:4], entry="tk_scatter_conj_probe_atomic")
        scatter_conj_probe.launches += 1
        scatter_conj_probe.variant = variant
        return out
    tiles_y, tiles_x, _ = scatter_tile_plan(t, nz, n)

    def checked(x, dtype, what):
        if (x.shape != (t, nz, n) or x.dtype != dtype
                or x.device != nearplane.device or not x.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                             f"tensor of shape {(t, nz, n)} on "
                             f"{nearplane.device}")
        return x

    if partial is not None:
        checked(partial, torch.complex128, "partial")
    elif from_partial or not last:
        raise ValueError(f"{name}: continuing from or keeping running sums "
                         "needs partial")
    if not last:
        out = None
    elif out is None:
        # Every pixel is stored by the kernel, covered or not.
        out = torch.empty((t, nz, n), dtype=torch.complex64,
                          device=nearplane.device)
    else:
        checked(out, torch.complex64, "out")
    if boxes is None:
        if first:
            raise ValueError(f"{name}: first={first} needs the boxes of "
                             "the whole scan")
        boxes = scatter_boxes(scan_int, nz, n, p)
    chunks = -(-(first + s) // SCATTER_CHUNK)
    if (first < 0 or boxes.dtype != torch.int32 or boxes.ndim != 3
            or boxes.shape[0] != t or boxes.shape[1] < chunks
            or boxes.shape[2] != 4 or not boxes.is_contiguous()
            or boxes.device != nearplane.device):
        raise ValueError(f"{name}: boxes must be a contiguous int32 tensor "
                         f"({t}, >= {chunks}, 4) on {nearplane.device} for "
                         f"first={first}, got {tuple(boxes.shape)}")
    if scan_int.data_ptr() % 8:  # read a position (8 bytes) at a time
        scan_int = scan_int.clone()
    _launch(name, fused._device_index(nearplane), nearplane.data_ptr(),
            prb.data_ptr(), scan_int.data_ptr(),
            None if out is None else out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            boxes.data_ptr() if skip else None, t, s, nz, n, m,
            p, *nearplane.stride()[:4], tiles_y, tiles_x,
            scatter_mode_chunk(m), int(bool(from_partial)),
            boxes.shape[1], first)
    scatter_conj_probe.launches += 1
    scatter_conj_probe.variant = variant
    return out if last else partial


def _adj_probe_reduce_cuda(nearplane, scan_int, psi):
    name = "adj_probe_reduce"
    t, s, m, p = _check_frames(name, nearplane, scan_int, psi, "psi")
    _, nz, n = psi.shape
    out = torch.empty((t, m, p, p), dtype=torch.complex64,
                      device=nearplane.device)
    if t == 0 or s == 0 or m == 0 or p == 0:
        return out.zero_()
    if t > _MAX_GRID_YZ:
        raise ValueError(f"{name}: at most {_MAX_GRID_YZ} angles, got {t}")
    per_block = _lib(name).tk_adj_probe_reduce_pixels_per_block()
    chunks = -(-p * p // per_block)
    groups = max(1, min(s, _MAX_GRID_YZ, -(-_TARGET_BLOCKS // (chunks * t))))
    groups = -(-s // -(-s // groups))  # no empty run of positions
    acc = torch.empty((groups, t, m, p, p), dtype=torch.complex64,
                      device=nearplane.device)
    psi, scan_int = psi.contiguous(), scan_int.contiguous()
    _launch(name, fused._device_index(nearplane), nearplane.data_ptr(),
            psi.data_ptr(), scan_int.data_ptr(), out.data_ptr(),
            acc.data_ptr(), t, s, nz, n, m, p, groups,
            *nearplane.stride()[:4])
    adj_probe_reduce.launches += 1
    return out
