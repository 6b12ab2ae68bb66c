"""The L-BFGS direction's two passes over memory: the hand-written
``lbfgs_gram`` and ``lbfgs_combine``.

They replace no TPU kernel: the JAX package's two-loop recursion is ``jnp``
in a ``fori_loop`` (``tikejax.solvers.cg`` ``lbfgs_direction``), 2m + 1
inner products and 2m axpys, each a pass over an object-sized array. The
solver (``solvers.cg._Engine.lbfgs_direction``) runs the same recursion on
scalars instead, from the inner products that :func:`lbfgs_gram` reads in
one pass, and writes the direction with :func:`lbfgs_combine`:

* :func:`lbfgs_gram` -- the real inner products ``<a, b> = Re(vdot(a, b))``
  of the gradient ``g`` and the new pair ``s = gamma * d_prev``,
  ``y = g - g_prev`` (formed inside from ``d_prev``, ``g`` and ``g_prev``)
  against every ring slot and against ``g``, ``s``, ``y``. Sums in float64;
  only the first ``rows`` rows of each plane count (the owned rows of an
  object slab).
* :func:`lbfgs_combine` -- ``d = -(c_g g + sum_k a_k S_k + b_k Y_k)``, and
  in the same pass the pair ``(s, y)`` stored into ring slot ``slot``.

The ring is ``(m, *g.shape)``; a slot whose two coefficients are both 0 is
not read. The CUDA source is ``tikejax_torch/csrc/lbfgs.cu``; its note says
what bounds each pass (bytes) and how the sums stay bitwise repeatable. On a
CUDA tensor each function launches its kernels or raises (complex64 or
complex128, contiguous, every array on one card); on a CPU tensor it runs
its ``*_reference``, the plain PyTorch version. Each keeps an integer count
of its runs in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from tikejax_torch.ops import _launch

MAX_M = 32  # the largest ring the kernels take (direction='lbfgs:<m>')
_CHUNK = 4096  # elements a block of the Gram pass sums
_MAX_CHUNKS = 65535  # the grid's second dimension
_THREADS = 256


def lbfgs_gram(S: torch.Tensor, Y: torch.Tensor, g: torch.Tensor,
               g_prev: torch.Tensor, d_prev: torch.Tensor, gamma: float,
               rows: int | None = None) -> torch.Tensor:
    """The inner products the L-BFGS recursion and the ring's push need.

    Args:
      S, Y: the ``(m, ...)`` rings of object-shaped arrays, by slot.
      g, g_prev, d_prev: the gradient, the previous gradient and the
        previous direction, shaped like a slot.
      gamma: the previous step: ``s = gamma * d_prev``, ``y = g - g_prev``.
      rows: the rows of each ``(..., rows_all, cols)`` plane that count
        (the first ``rows``); None counts every row.

    Returns:
      ``(3, 2m + 3)`` float64, rows ``(g, s, y)`` against
      ``(S_0..S_{m-1}, Y_0..Y_{m-1}, g, s, y)``.
    """
    if not _launch.route("lbfgs_gram", S):
        return lbfgs_gram_reference(S, Y, g, g_prev, d_prev, gamma, rows)
    return _lbfgs_gram_cuda(S, Y, g, g_prev, d_prev, gamma, rows)


lbfgs_gram.launches = 0


def _owned(x, rows):
    return x if rows is None else x[..., :rows, :]


def lbfgs_gram_reference(S, Y, g, g_prev, d_prev, gamma: float,
                         rows=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`lbfgs_gram`: one float64 matrix
    product of the vectors viewed as real."""
    lbfgs_gram_reference.launches += 1
    left = [_owned(v, rows) for v in (g, gamma * d_prev, g - g_prev)]
    right = [_owned(v, rows) for v in (*S, *Y)] + left

    def rows_of(vectors):
        return torch.stack([torch.view_as_real(v).reshape(-1)
                            for v in vectors]).to(torch.float64)

    return rows_of(left) @ rows_of(right).T


lbfgs_gram_reference.launches = 0


def lbfgs_combine(S: torch.Tensor, Y: torch.Tensor, g, g_prev, d_prev,
                  gamma: float, slot: int, c_g: float, a, b) -> torch.Tensor:
    """``-(c_g g + sum_k a[k] S[k] + b[k] Y[k])``, summed in float64 and
    rounded once; with ``slot >= 0`` the pair ``s = gamma * d_prev``,
    ``y = g - g_prev`` is first stored in place into ``S[slot]`` and
    ``Y[slot]`` and enters the sum there (``g_prev`` and ``d_prev`` are not
    read otherwise). ``a`` and ``b`` are m host floats by slot; a slot whose
    two coefficients are 0 is not read."""
    if not _launch.route("lbfgs_combine", S):
        return lbfgs_combine_reference(S, Y, g, g_prev, d_prev, gamma, slot,
                                       c_g, a, b)
    return _lbfgs_combine_cuda(S, Y, g, g_prev, d_prev, gamma, slot, c_g, a,
                               b)


lbfgs_combine.launches = 0


def lbfgs_combine_reference(S, Y, g, g_prev, d_prev, gamma, slot, c_g, a,
                            b) -> torch.Tensor:
    """Plain PyTorch version of :func:`lbfgs_combine`, in complex128, in the
    kernel's order: ``c_g g``, then slot by slot ``a_k S_k`` and
    ``b_k Y_k``."""
    lbfgs_combine_reference.launches += 1
    if slot >= 0:
        S[slot] = gamma * d_prev
        Y[slot] = g - g_prev
    wide = torch.complex128
    acc = c_g * g.to(wide)
    for k in range(S.shape[0]):
        if a[k] != 0.0:
            acc = acc + a[k] * S[k].to(wide)
        if b[k] != 0.0:
            acc = acc + b[k] * Y[k].to(wide)
    return (-acc).to(g.dtype)


lbfgs_combine_reference.launches = 0


# -- the CUDA path -------------------------------------------------------

def _check(name: str, S, Y, others) -> bool:
    """Checks of the kernels' inputs; True for complex128."""
    if S.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"{name}: the CUDA kernels take complex64 or "
                        f"complex128, got {S.dtype}")
    expect = {"S": (S, S.dtype), "Y": (Y, S.dtype)}
    expect.update({k: (v, S.dtype) for k, v in others.items()})
    _launch.check_types(name, expect)
    m = S.shape[0]
    if not 1 <= m <= MAX_M or Y.shape != S.shape:
        raise ValueError(f"{name}: rings of 1 to {MAX_M} slots of one "
                         f"shape, got S {tuple(S.shape)}, Y "
                         f"{tuple(Y.shape)}")
    for what, x in {"S": S, "Y": Y, **others}.items():
        if not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, x in others.items():
        if x.shape != S.shape[1:]:
            raise ValueError(f"{name}: {what} is {tuple(x.shape)}, a ring "
                             f"slot {tuple(S.shape[1:])}")
    return S.dtype == torch.complex128


def _lbfgs_gram_cuda(S, Y, g, g_prev, d_prev, gamma, rows):
    name = "lbfgs_gram"
    wide = _check(name, S, Y, {"g": g, "g_prev": g_prev, "d_prev": d_prev})
    m = S.shape[0]
    if S.dim() < 3:
        raise ValueError(f"{name}: slots of (..., rows, cols), got "
                         f"{tuple(S.shape[1:])}")
    nrows, cols = S.shape[-2:]
    rows = nrows if rows is None else rows
    if not 1 <= rows <= nrows:
        raise ValueError(f"{name}: rows {rows} outside 1..{nrows}")
    plane, owned = nrows * cols, rows * cols
    planes = S[0].numel() // plane
    chunk = max(_CHUNK, -(-owned * planes // _MAX_CHUNKS))
    chunks = planes * -(-owned // chunk)
    if chunks > _MAX_CHUNKS:
        raise ValueError(f"{name}: {planes} planes are too many")
    outputs = 3 * (2 * m + 3)
    partial = torch.empty(outputs * chunks, dtype=torch.float64,
                          device=S.device)
    out = torch.empty(outputs, dtype=torch.float64, device=S.device)
    _launch.launch("lbfgs", "tk_lbfgs_gram", _launch.device_index(S),
                   S.data_ptr(), Y.data_ptr(), g.data_ptr(), g_prev.data_ptr(),
                   d_prev.data_ptr(), float(gamma), partial.data_ptr(),
                   out.data_ptr(), S[0].numel(), plane, owned, chunk, m,
                   int(wide))
    lbfgs_gram.launches += 1
    return out.view(3, 2 * m + 3)


def _lbfgs_combine_cuda(S, Y, g, g_prev, d_prev, gamma, slot, c_g, a, b):
    name = "lbfgs_combine"
    others = {"g": g}
    if slot >= 0:
        others.update(g_prev=g_prev, d_prev=d_prev)
    wide = _check(name, S, Y, others)
    m = S.shape[0]
    if not -1 <= slot < m or len(a) != m or len(b) != m:
        raise ValueError(f"{name}: slot {slot} and {len(a)}, {len(b)} "
                         f"coefficients for a ring of {m}")
    n = g.numel()
    out = torch.empty_like(g)
    coeffs = ctypes.c_double * m
    dev = _launch.device_index(S)
    grid = max(1, min(-(-n // _THREADS), 8 * _launch.sms(dev)))
    ptr = (lambda x: x.data_ptr()) if slot >= 0 else (lambda x: None)
    _launch.launch("lbfgs", "tk_lbfgs_combine", dev, S.data_ptr(),
                   Y.data_ptr(), g.data_ptr(), ptr(g_prev), ptr(d_prev),
                   out.data_ptr(), float(gamma), float(c_g), coeffs(*a),
                   coeffs(*b), n, m, slot, int(wide), grid)
    lbfgs_combine.launches += 1
    return out

