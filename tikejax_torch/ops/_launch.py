"""How the port's CUDA kernels are loaded, bound, launched and checked.

Every kernel wrapper of ``ops.fused``, ``ops.kernels``, ``ops.linesearch``
and ``ops.lbfgs`` goes through this module and makes none of these
decisions itself:

* :func:`lib` loads ``csrc/<name>.cu``'s library once (``cuda_build``
  builds it first where needed) and binds every entry point of
  :data:`ENTRIES`, the one table of the C interface;
* :func:`launch` calls an entry point on the device's current stream and
  turns a refused launch into a ``RuntimeError`` that carries the CUDA
  error;
* the occupancy queries (:func:`blocks_per_sm`, :func:`fft_launch_config`)
  and the grids worked out from them (:func:`fft_grid`, :func:`gemm_grid`),
  cached per card;
* the input checks the wrappers share (:func:`route`, :func:`check_types`,
  :func:`check_model`, :func:`check_sizes`, :func:`device_index`).

Nothing here runs at import time: importing the package needs no compiler
and no card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tikejax_torch.utils import cuda_build

MODEL_CODE = {"gaussian": 0, "poisson": 1}
# The DFT kernels' twiddle table lives in shared memory beside their tiles.
MAX_NDET = 2048
# Per-block scratch holds one frame's intermediates; the grid is cut so
# that all of it stays below this many bytes.
SCRATCH_BYTES = 256 * 1024**2

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_OUT = ctypes.POINTER(ctypes.c_int)
# Occupancy queries: (side, has_base, &blocks) of a DFT-GEMM kernel and
# (side, has_base, planes, threads, &blocks, &shared bytes) of an FFT one.
_GEMM_BLOCKS = [_I, _I, _OUT]
_FFT_BLOCKS = [_I] * 4 + [_OUT] * 2
_STRIDES = [_L] * 4  # a frame tensor's strides (angle, position, mode, row)
_FFT = {  # the FFT variants: pointers, then sizes; the last int the threads
    "grad_fused": [_P] * 8 + [_I] * 9 + [_L] * 2 + [_I] * 4,
    "fwd": [_P] * 5 + [_I] * 9,
    "minf_fused": [_P] * 6 + [_I] * 11,
    "grad_prb_fused": [_P] * 7 + [_I] * 11,
    "adj": [_P] * 3 + [_I] * 7 + [_L] + [_I] * 2,
    "adj_probe": [_P] * 5 + [_I] * 9,
    "adj_residual": [_P] * 6 + [_I] * 8 + [_L] * 2 + [_I] * 4,
    "fwd_quad_stats": [_P] * 7 + [_I] * 9,
}
_GEMM = {  # the DFT-GEMM variants
    "grad_fused": [_P] * 9 + [_I] * 8 + [_L] * 2 + [_I] * 3,
    "fwd": [_P] * 6 + [_I] * 8,
    "minf_fused": [_P] * 7 + [_I] * 9 + [_L],
    "grad_prb_fused": [_P] * 8 + [_I] * 9,
    "adj": [_P] * 4 + [_I] * 7 + [_L, _I],
    "adj_probe": [_P] * 6 + [_I] * 8,
    "adj_residual": [_P] * 7 + [_I] * 8 + [_L] * 2 + [_I] * 3 + [_L],
    "fwd_quad_stats": [_P] * 8 + [_I] * 8,
}
# The C interface: the argument types of every entry point, by library.
# :func:`lib` appends the stream to each but the queries
# (:func:`takes_stream`), which launch nothing.
ENTRIES = {
    **{name: {f"tk_{name}": _GEMM[name],
              f"tk_{name}_blocks_per_sm": _GEMM_BLOCKS,
              f"tk_{name}_fft": _FFT[name],
              f"tk_{name}_fft_blocks_per_sm": _FFT_BLOCKS}
       for name in _FFT},
    "ls_objectives": {
        "tk_ls_objectives_frame": [_P] * 6 + [_L] + [_I] * 7,
        "tk_ls_objectives_frame_blocks_per_sm": [_I, _OUT]},
    "gather_probe_mul": {"tk_gather_probe_mul": [_P] * 4 + [_I] * 7},
    "scatter_conj_probe": {
        # + tiles_y, tiles_x, mode_chunk, from_partial, box_chunks, first
        "tk_scatter_conj_probe": [_P] * 6 + [_I] * 6 + _STRIDES + [_I] * 6,
        "tk_scatter_conj_probe_atomic": [_P] * 4 + [_I] * 6 + _STRIDES,
        "tk_scatter_conj_probe_blocks_per_sm": [_I, _OUT]},
    "adj_probe_reduce": {
        "tk_adj_probe_reduce": [_P] * 5 + [_I] * 7 + _STRIDES,
        "tk_adj_probe_reduce_pixels_per_block": []},
    "lbfgs": {
        "tk_lbfgs_gram": [_P] * 5 + [_D] + [_P] * 2 + [_L] * 3 + [_I] * 3,
        "tk_lbfgs_combine": [_P] * 6 + [_D] * 2 + [_P] * 2 + [_L]
        + [_I] * 4},
}
# The forced one-pass kernels with fp32 atomics, and the fused bodies of
# grad_fused and minf_fused (REGS_BODIES).
ENTRIES["grad_fused"]["tk_grad_fused_atomic_fft"] = [_P] * 6 + [_I] * 11
REGS_BODIES = ("grad_fused", "minf_fused")
for _name in REGS_BODIES:
    ENTRIES[_name].update({f"tk_{_name}_fft_regs": _FFT[_name],
                           f"tk_{_name}_fft_regs_blocks_per_sm": _FFT_BLOCKS})
ENTRIES["adj_residual"]["tk_adj_residual_atomic_fft"] = [_P] * 6 + [_I] * 10
ENTRIES["adj"]["tk_adj_atomic_fft"] = [_P] * 4 + [_I] * 9


def takes_stream(symbol: str) -> bool:
    """Every entry point takes the stream as its last argument but the
    queries (``*_blocks_per_sm``, ``*_per_block``)."""
    return not symbol.endswith(("_blocks_per_sm", "_per_block"))


@functools.cache
def lib(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` built with ``defines``, every entry
    point of ``ENTRIES[name]`` bound."""
    handle = cuda_build.load(name, defines)
    for symbol, argtypes in ENTRIES[name].items():
        fn = getattr(handle, symbol)
        fn.argtypes = argtypes + ([_P] if takes_stream(symbol) else [])
        fn.restype = ctypes.c_int
    handle.tk_error_string.argtypes = [ctypes.c_int]
    handle.tk_error_string.restype = ctypes.c_char_p
    return handle


def check(name: str, err: int, what: str) -> None:
    """Raise where ``err``, a CUDA error code of library ``name``, is not
    0."""
    if err:
        raise RuntimeError(f"{name}: {what} failed: "
                           f"{lib(name).tk_error_string(err).decode()}")


def launch(name: str, symbol: str, device_index: int, *args) -> None:
    """``symbol(*args, stream)`` of library ``name`` on the current stream
    of card ``device_index``; a refused launch raises."""
    fn = getattr(lib(name), symbol)
    with torch.cuda.device(device_index):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        check(name, err, f"kernel launch ({symbol})")


@functools.cache
def constant(name: str, symbol: str) -> int:
    """What the query ``symbol()`` of library ``name`` returns: a constant
    of the build."""
    return getattr(lib(name), symbol)()


@functools.cache
def sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def blocks_per_sm(name: str, symbol: str, device_index: int, *args) -> int:
    """Resident blocks per SM that the occupancy query ``symbol(*args,
    &blocks)`` of library ``name`` reports on card ``device_index``."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(name, getattr(lib(name), symbol)(*args, ctypes.byref(per_sm)),
              f"occupancy query ({symbol}{args})")
    return per_sm.value


def fft_threads(ndet: int) -> int:
    """Threads per block of the FFT kernels: 1024 at 128^2 (64 registers a
    thread, no spills; 19% faster than 512 on an H100 for both kernels),
    512 at the smaller sides."""
    return 1024 if ndet == 128 else 512


def fft_entry(name: str, body: str = "fft_smem") -> str:
    """The C entry point of the FFT variant of ``name``; ``body='fft_regs'``
    names the fused body of ``grad_fused`` or ``minf_fused``
    (:data:`REGS_BODIES`, ``fused.fft_body``), the other kernels have one
    body."""
    regs = name in REGS_BODIES and body == "fft_regs"
    return f"tk_{name}_fft_regs" if regs else f"tk_{name}_fft"


@functools.cache
def fft_launch_config(name: str, device_index: int, ndet: int,
                      planes: int = 0, has_base: bool = False,
                      defines: tuple[str, ...] = (),
                      body: str = "fft_smem") -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared memory in bytes) of the FFT
    variant of ``name`` (``'grad_fused'``, ``'minf_fused'``,
    ``'grad_prb_fused'``, ``'fwd'``, ``'adj'``, ``'adj_probe'``,
    ``'adj_residual'`` or ``'fwd_quad_stats'``) at detector side ``ndet``
    with :func:`fft_threads` threads, with ``planes`` (0 or 1) float planes
    beside the frame (one with several modes, or with one mode and the data
    prefetch of the first three; ``fwd``, ``adj``, ``adj_probe`` and
    ``fwd_quad_stats`` have none); ``body='fft_regs'`` asks for the fused
    body of ``grad_fused`` or ``minf_fused``; raises for a side without a
    kernel."""
    threads = fft_threads(ndet)
    per_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
    query = getattr(lib(name, defines),
                    f"{fft_entry(name, body)}_blocks_per_sm")
    with torch.cuda.device(device_index):
        check(name, query(ndet, int(has_base), planes, threads,
                          ctypes.byref(per_sm), ctypes.byref(smem)),
              f"occupancy query ({body}, ndet={ndet}, threads={threads})")
    return per_sm.value, smem.value


def fft_grid(name, device_index, frames, ndet, planes, has_base,
             body="fft_smem") -> int:
    """Blocks of the FFT variant: what the card holds at once, at most one
    per frame."""
    per_sm, _ = fft_launch_config(name, device_index, ndet, planes, has_base,
                                  (), body)
    return max(1, min(frames, max(1, per_sm) * sms(device_index)))


def gemm_grid(name, device_index, frames, ndet, has_base, block_bytes) -> int:
    """Blocks of the DFT-GEMM variant: what the card holds at once, at most
    one per frame, their scratch of ``block_bytes`` each within
    :data:`SCRATCH_BYTES`."""
    per_sm = blocks_per_sm(name, f"tk_{name}_blocks_per_sm", device_index,
                           ndet, int(has_base))
    return max(1, min(frames, max(1, per_sm) * sms(device_index),
                      SCRATCH_BYTES // block_bytes))


def route(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
    return True


def device_index(x: torch.Tensor) -> int:
    return (x.device.index if x.device.index is not None
            else torch.cuda.current_device())


def check_types(name, expect) -> None:
    """Every tensor of ``expect`` ({what: (tensor, dtype)}) must lie on
    the first one's device and have its dtype."""
    device = next(iter(expect.values()))[0].device
    for what, (x, dtype) in expect.items():
        if x.device != device:
            raise ValueError(f"{name}: {what} is on {x.device}, the other "
                             f"inputs on {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {what} as "
                            f"{dtype}, got {x.dtype}")


def check_model(model: str) -> None:
    if model not in MODEL_CODE:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{tuple(MODEL_CODE)}")


def check_sizes(name, nprb, ndet) -> None:
    if not nprb <= ndet <= MAX_NDET:
        raise ValueError(f"{name}: need nprb <= ndet <= {MAX_NDET}, "
                         f"got nprb={nprb}, ndet={ndet}")
