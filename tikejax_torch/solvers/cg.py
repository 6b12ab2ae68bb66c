"""Object-only Dai-Yuan conjugate-gradient ptychography solver.

Counterpart of the object-only subset of ``tikejax.solvers.cg``: the same
options (same names and defaults), the same Dai-Yuan direction, warm-started
backtracking (or interpolating) line search, illumination preconditioner,
stopping rules and metrics. Two loop bodies, as in the JAX package:

* the MERGED body (the main path on CUDA, ``kernel='fused*'``): every
  line-search candidate is evaluated by one ``grad_fused`` pass, which
  returns the objective and the gradient together, so the accepted
  candidate's gradient seeds the next iteration;
* the CLASSIC body (``kernel='xla'``, the 'auto' choice off CUDA): a
  gradient pass through the oracle operators, then a line search on the
  quadratic statistics of the two farplanes.

Execution model. The JAX package runs the whole loop, data-dependent
``while_loop``s included, in one jit with no host round trip. Eager PyTorch
cannot branch on ``f(candidate) > f(current)`` without reading the value, so
this solver keeps the step control on the host and reads ONE scalar per
line-search candidate (plus the directional derivative when the 'interp'
step needs it, and two scalars at the start). Everything array-valued stays
on the device. ``metrics['host_syncs']`` counts the reads and
``metrics['evaluations']`` the objective evaluations.

Not ported (each raises NotImplementedError naming ROADMAP.md): joint probe
recovery, ``nchunks > 1``, L-BFGS directions, carried CG state, the
split-operator ``f_base``, ``memory='materialized'``, the fused line search,
``precondition='illum_lowk'``, mesh axes, the slab fields and the TPU
slab planner / compile-retry ladder (``run`` calls ``run_impl`` directly).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.models import likelihoods
from tikejax_torch.ops import diffraction, fused
from tikejax_torch.ops import patches as _patches


@dataclasses.dataclass(frozen=True)
class CGOptions:
    """Solver configuration; the fields and defaults of the JAX package's
    ``CGOptions`` that this port implements.

    Attributes:
      piter: maximum number of CG iterations.
      model: 'gaussian' or 'poisson' likelihood.
      step0: initial line-search step.
      step_shrink: backtracking shrink factor.
      max_halvings: bound on backtracking steps (then gamma=0, no move).
      kernel: 'auto' (fused_mx on CUDA -- fused_hp for a deep
        target_residual, 'fused' for a shallow one -- and 'xla'
        elsewhere), any 'fused*' tier (all run the fp32 ``grad_fused``
        kernel), or 'xla' (the oracle operators).
      precondition: 'illum' (divide the gradient by the probe-illumination
        map, floored at 10% of its maximum), 'max' (the scalar
        1/max sum_m |prb_m|^2) or 'none'.
      adaptive_step: warm-start the line search from the previous step.
      step_growth: warm-start regrow factor (>= 1).
      step_policy: 'regrow' (start from min(step0, growth * previous
        accepted step)), 'track' (grow only after an outright accept) or
        'auto' (= 'regrow').
      target_residual: stop once the relative residual reaches this
        (0 disables).
      direction: 'auto' or 'dy' (Dai-Yuan).
      stop_on_stall: stop after this many consecutive fully-failed line
        searches (0 disables).
      linesearch: 'backtracking', 'interp' (one safeguarded quadratic-
        interpolation step on the first rejection) or 'auto'
        (backtracking on the fused_mp/hp/mx/hx tiers, interp otherwise).
      memory: 'auto' or 'frameless' (no farplane on the fused path).
      merged_linesearch: 'auto' (evaluate every candidate with its
        gradient on the fused path) or 'off'.
    """

    piter: int = 32
    model: str = "gaussian"
    step0: float = 1.0
    step_shrink: float = 0.5
    max_halvings: int = 16
    kernel: str = "auto"
    precondition: str = "illum"
    adaptive_step: bool = True
    step_growth: float = 4.0
    step_policy: str = "auto"
    target_residual: float = 0.0
    direction: str = "auto"
    stop_on_stall: int = 2
    linesearch: str = "auto"
    memory: str = "auto"
    merged_linesearch: str = "auto"


# The JAX package's remaining CGOptions fields with their defaults: a call
# that keeps the default runs, any other value raises.
_UNPORTED_FIELDS = {
    "recover_prb": False, "nchunks": 1, "axis_name": None,
    "theta_axis_name": None, "obj_axis_name": None, "obj_halo": 0,
    "obj_axis_size": 1, "verbose_every": 0, "lowk_boost": 4.0,
    "lowk_frac": 0.05, "fused_linesearch": False, "carry_state": False,
    "carry_lbfgs": False, "obj_slabs": 1, "obj_slabs_partitioned": False,
    "obj_slab_rows": None, "obj_slab_cols": 1, "kernel_frames": None,
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tikejax_torch yet; see ROADMAP.md "
        "(queue 1, 'the rest of the solver surface', and queue 2 for its "
        "kernels)")


def _rdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real inner product of complex arrays viewed as real vectors."""
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def _quad_stats(fpsi, fd):
    """Per-pixel quadratic coefficients of |fpsi + gamma*fd|^2 summed over
    modes: (a, b, c) of shape (ntheta, nscan, nd, nd)."""
    a = likelihoods.total_intensity(fpsi)
    b = torch.sum((torch.conj(fpsi) * fd).real, dim=2)
    c = likelihoods.total_intensity(fd)
    return a, b, c


def _minf_of_gamma(model, a, b, c, data, gamma):
    """Objective at psi + gamma*d from quadratic statistics."""
    intensity = torch.clamp_min(a + 2.0 * gamma * b + gamma * gamma * c, 0.0)
    d = torch.clamp_min(data, 0.0)
    if model == "gaussian":
        amp = torch.sqrt(intensity + 1e-12)
        return torch.sum((amp - torch.sqrt(d))**2)
    return torch.sum(intensity - d * torch.log(intensity + 1e-8))


class _Engine:
    """Geometry/options-bound internals of the CG loop; counts the host
    reads it makes in ``syncs`` and its objective evaluations (gradient
    passes and line-search candidates) in ``evaluations``."""

    def __init__(self, g: Geometry, o: CGOptions, backend: str):
        if o.model not in likelihoods.MODELS:
            raise ValueError(f"unknown model {o.model!r}")
        if o.precondition == "illum_lowk":
            raise _not_ported("precondition='illum_lowk'")
        if o.precondition not in ("illum", "max", "none"):
            raise ValueError(f"unknown precondition {o.precondition!r}; "
                             "expected 'illum', 'illum_lowk', 'max', or "
                             "'none'")
        if o.memory == "materialized":
            raise _not_ported("memory='materialized'")
        if o.memory not in ("auto", "frameless"):
            raise ValueError(f"unknown memory policy {o.memory!r}")
        if o.linesearch == "parabolic":
            raise _not_ported("linesearch='parabolic'")
        if o.linesearch not in ("auto", "interp", "backtracking"):
            raise ValueError(f"unknown linesearch {o.linesearch!r}; "
                             "expected 'auto', 'interp', 'backtracking',"
                             " or 'parabolic'")
        if o.merged_linesearch not in ("auto", "off"):
            raise ValueError(f"unknown merged_linesearch "
                             f"{o.merged_linesearch!r}; expected 'auto' "
                             "or 'off'")
        if o.direction not in ("auto", "dy"):
            if o.direction.partition(":")[0] == "lbfgs":
                raise _not_ported(f"direction={o.direction!r}")
            raise ValueError(f"unknown direction {o.direction!r}; "
                             "expected 'auto', 'dy', 'lbfgs', or "
                             "'lbfgs:<m>'")
        if o.step_policy not in ("auto", "track", "regrow"):
            raise ValueError(f"unknown step_policy {o.step_policy!r}; "
                             "expected 'auto', 'track', or 'regrow'")
        if o.target_residual < 0:
            raise ValueError("target_residual must be >= 0")
        if o.step_growth < 1.0:
            raise ValueError("step_growth must be >= 1 (the warm start "
                             "may only regrow toward step0)")
        if o.stop_on_stall < 0:
            raise ValueError("stop_on_stall must be >= 0")
        diffraction._check_kernel(o.kernel)
        self.kernel = diffraction.resolve_kernel(o.kernel, backend)
        if self.kernel == "pallas":
            raise _not_ported("kernel='pallas' (the hybrid kernels)")
        self.fused = self.kernel.startswith("fused")
        self.ls = o.linesearch
        if self.ls == "auto":
            deep = self.kernel in ("fused_mp", "fused_hp", "fused_mx",
                                   "fused_hx")
            self.ls = "backtracking" if deep else "interp"
        self.merged = o.merged_linesearch == "auto" and self.fused
        if self.fused and not self.merged:
            raise _not_ported("merged_linesearch='off' on a fused tier "
                              "(it needs the minf_fused kernel)")
        self.g = g
        self.o = o
        self.minf_fn, self.resid_fn = likelihoods.get_model(o.model)
        self.syncs = 0
        self.evaluations = 0

    def host(self, x: torch.Tensor) -> float:
        """Read a device scalar on the host (one synchronisation)."""
        self.syncs += 1
        return float(x)

    # -- gradient and line-search passes --------------------------------

    def grad_pass(self, psi, prb, scan, scan_i, data):
        """(minf, raw object gradient, farplane or None) at ``psi``."""
        self.evaluations += 1
        if self.fused:
            grad, f0 = fused.grad_fused(
                psi, data, scan_i, prb, self.g.ndet, self.o.model,
                precision=diffraction._fused_precision(self.kernel),
                adj_precision=diffraction._fused_adj_precision(self.kernel))
            return f0, grad, None
        fpsi = diffraction.fwd_raw(psi, scan, prb, self.g.ndet, "xla")
        resid = self.resid_fn(fpsi, data)
        grad = diffraction.adj_raw(resid, scan, prb, self.g.nz, self.g.n,
                                   "xla")
        return self.minf_fn(fpsi, data), grad, fpsi

    def gamma0(self, gamma_prev: float, gamma0_prev: float) -> float:
        """Warm start: ``gamma_prev`` is the last ACCEPTED step (0 on
        failure), ``gamma0_prev`` the start used last iteration."""
        o = self.o
        if not o.adaptive_step:
            return o.step0
        if o.step_policy in ("auto", "regrow"):
            if gamma_prev > 0:
                return min(o.step0, o.step_growth * gamma_prev)
            return o.step0
        if gamma_prev > 0:
            grown = (o.step_growth * gamma_prev
                     if gamma_prev >= gamma0_prev else gamma_prev)
            return min(o.step0, grown)
        return gamma0_prev if gamma0_prev > 0 else o.step0

    def interp_gamma(self, gamma0, f0, fg0, fp0):
        """Safeguarded quadratic-interpolation candidate after the first
        candidate was rejected, clipped to [shrink^2, shrink] * gamma0."""
        o = self.o
        denom = fg0 - f0 - fp0 * gamma0
        if denom > 0 and fp0 < 0:
            gi = -fp0 * gamma0 * gamma0 / (2.0 * denom)
        else:
            gi = gamma0 * o.step_shrink
        lo = o.step_shrink * o.step_shrink * gamma0
        return min(max(gi, lo), o.step_shrink * gamma0)

    def line_search(self, f_of, f0, gamma0, fp0):
        """Largest gamma in {gamma0 * shrink^k} with f(gamma) <= f0 (the
        first halving replaced by the interpolation step under 'interp');
        gamma = 0 if none within max_halvings. ``f_of(gamma)`` returns
        (objective on the host, payload); ``fp0()`` the directional
        derivative on the host. Returns (gamma, f, payload) of the last
        candidate evaluated."""
        o = self.o
        gamma = gamma0
        fg, payload = f_of(gamma)
        k = 0
        if self.ls == "interp" and o.max_halvings > 0 and fg > f0:
            gamma = self.interp_gamma(gamma0, f0, fg, fp0())
            fg, payload = f_of(gamma)
            k = 1
        while fg > f0 and k < o.max_halvings:
            gamma = gamma * o.step_shrink
            fg, payload = f_of(gamma)
            k += 1
        return (gamma if fg <= f0 else 0.0), fg, payload

    def dy_direction(self, grad, grad_prev, d_prev):
        """d = -g + beta * d_prev, beta = ||g||^2 / <d_prev, g - g_prev>_R
        (Dai-Yuan 1999); steepest descent when the denominator is 0."""
        num = _rdot(grad, grad)
        den = _rdot(d_prev, grad - grad_prev)
        beta = torch.where(den != 0, num / torch.where(den != 0, den, 1.0),
                           0.0)
        return -grad + beta.to(grad.dtype) * d_prev

    def keep_going(self, i: int, residual: list, gamma: list) -> bool:
        """The JAX package's loop condition, on the host metrics."""
        o = self.o
        if i >= o.piter:
            return False
        if o.target_residual > 0 and i > 0 and not (
                residual[i - 1] > o.target_residual):
            return False
        n = o.stop_on_stall
        return not (n > 0 and i >= n and all(g == 0 for g in gamma[i - n:i]))


def _sum_over_positions(fn, data, chunk_bytes=64 * 2**20):
    """``sum(fn(chunk))`` over chunks of scan positions, so that no
    data-sized temporary is allocated (the data are the largest array of
    the problem: 1 GiB at 16384 frames of 128^2)."""
    frame_bytes = data.shape[0] * data[0, 0].numel() * data.element_size()
    step = max(1, chunk_bytes // frame_bytes)
    return sum(fn(c) for c in data.split(step, dim=1))


def _preconditioner(o: CGOptions, prb, scan_i, nz, n):
    """The object-gradient preconditioner; for 'illum' its denominator is
    computed once (the probe does not change in an object-only run)."""
    power = torch.sum(prb.real**2 + prb.imag**2, dim=1)  # (t, nprb, nprb)
    if o.precondition == "illum":
        illum = _patches.illumination_map(scan_i, power, nz, n)
        m = torch.amax(illum, dim=(-2, -1), keepdim=True)
        denom = torch.maximum(illum, 0.1 * m)
        return lambda g: g / denom
    if o.precondition == "max":
        pmax = torch.amax(power, dim=(-2, -1))
        scale = 1.0 / torch.clamp_min(pmax, 1e-32)
        return lambda g: g * scale[:, None, None]
    return lambda g: g


@torch.no_grad()
def run_impl(geometry: Geometry, options: CGOptions, data, psi0, scan, prb0):
    """The CG loop. Returns (psi, prb, metrics) like :func:`run`."""
    o = options
    eng = _Engine(geometry, o, diffraction._backend(psi0.device))
    real_dtype = psi0.real.dtype
    device = psi0.device
    scan_i = _patches.scan_to_int(scan)
    precond = _preconditioner(o, prb0, scan_i, geometry.nz, geometry.n)

    sum_data = eng.host(_sum_over_positions(
        lambda c: torch.sum(torch.clamp_min(c, 0.0)), data))
    minf_offset = (eng.host(_sum_over_positions(
        likelihoods.poisson_perfect_minf, data))
        if o.model == "poisson" else 0.0)

    def residual_of(f):
        return math.sqrt(max(f - minf_offset, 0.0) / sum_data)

    minf, residual, gamma_hist, grad_norm = [], [], [], []
    psi = psi0
    d = torch.zeros_like(psi0)
    g_prev = torch.zeros_like(psi0)
    gam_prev = gam0_prev = 0.0
    if eng.merged:
        f_t, g_raw, _ = eng.grad_pass(psi0, prb0, scan, scan_i, data)
        f_cur = eng.host(f_t)
        g_cur = precond(g_raw)

    def fp0():
        # Directional derivative along d: 2 Re<raw gradient, d> (the
        # preconditioner rescales the gradient, not the objective).
        return 2.0 * eng.host(_rdot(g_raw, d))

    i = 0
    while eng.keep_going(i, residual, gamma_hist):
        if eng.merged:
            # Every candidate is evaluated with its gradient; the accepted
            # one seeds the next iteration.
            d = eng.dy_direction(g_cur, g_prev, d)
            gamma0 = eng.gamma0(gam_prev, gam0_prev)

            def f_of(gamma):
                fc, gc, _ = eng.grad_pass(psi + gamma * d, prb0, scan,
                                          scan_i, data)
                return eng.host(fc), gc

            gamma, fc, gc = eng.line_search(f_of, f_cur, gamma0, fp0)
            f_iter, g_iter = f_cur, g_cur
            g_prev = g_cur
            if fc <= f_cur:
                psi = psi + gamma * d
                g_cur, g_raw, f_cur = precond(gc), gc, fc
        else:
            f_t, g_raw, fpsi = eng.grad_pass(psi, prb0, scan, scan_i, data)
            f_iter = eng.host(f_t)
            g_iter = precond(g_raw)
            d = eng.dy_direction(g_iter, g_prev, d)
            gamma0 = eng.gamma0(gam_prev, gam0_prev)
            fd = diffraction.fwd_raw(d, scan, prb0, geometry.ndet, "xla")
            a, b, c = _quad_stats(fpsi, fd)

            def f_of(gamma):
                eng.evaluations += 1
                f = _minf_of_gamma(o.model, a, b, c, data, gamma)
                return eng.host(f), None

            gamma, _, _ = eng.line_search(f_of, f_iter, gamma0, fp0)
            if gamma != 0.0:
                psi = psi + gamma * d
            g_prev = g_iter
        minf.append(f_iter)
        residual.append(residual_of(f_iter))
        gamma_hist.append(gamma)
        grad_norm.append(torch.sqrt(_rdot(g_iter, g_iter)))
        gam_prev, gam0_prev = gamma, gamma0
        i += 1

    def padded(values):
        out = torch.zeros(o.piter, dtype=real_dtype, device=device)
        out[:len(values)] = torch.as_tensor(values, dtype=real_dtype,
                                            device=device)
        return out

    metrics = {
        "minf": padded(minf),
        "residual": padded(residual),
        "gamma": padded(gamma_hist),
        "grad_norm": padded(torch.stack(grad_norm) if grad_norm else []),
        "gamma_prb": torch.zeros(o.piter, dtype=real_dtype, device=device),
        "iters_run": torch.tensor(i, dtype=torch.int32),
        "host_syncs": eng.syncs,
        "evaluations": eng.evaluations,
    }
    return psi, prb0, metrics


def normalize_options(options: CGOptions, backend: str) -> CGOptions:
    """Resolve 'auto' kernel selection against the residual target for
    tensors on ``backend`` ('cuda' or 'cpu')."""
    if options.kernel == "auto":
        k = diffraction.resolve_kernel_for_target(
            "auto", options.target_residual, backend)
        options = dataclasses.replace(options, kernel=k)
    return options


def run(data, psi0, scan, prb0, geometry: Geometry,
        options: CGOptions | None = None, f_base=None, cg_init=None, **kw):
    """Reconstruct the object from measured intensities.

    The port's counterpart of ``tikejax.solvers.run`` for object-only
    runs; extra keyword arguments override CGOptions fields. The JAX
    package's other fields are accepted at their defaults and raise
    NotImplementedError otherwise, as do ``f_base`` and ``cg_init``.

    Returns:
      (psi, prb, metrics): metrics holds per-iteration arrays {'minf',
      'residual', 'gamma', 'grad_norm', 'gamma_prb'} of shape (piter,),
      zero past 'iters_run'; 'residual' is the relative misfit
      sqrt(max(minf - minf_perfect, 0) / sum(data)). 'host_syncs' counts
      the scalars the loop read on the host, 'evaluations' the objective
      evaluations (on the fused tiers, the ``grad_fused`` passes).
    """
    if f_base is not None:
        raise _not_ported("the split-operator f_base")
    if cg_init is not None:
        raise _not_ported("cg_init (carried CG state)")
    for name, default in _UNPORTED_FIELDS.items():
        if name in kw:
            value = kw.pop(name)
            if value != default:
                raise _not_ported(f"{name}={value!r}")
    if options is None:
        options = CGOptions(**kw)
    elif kw:
        options = dataclasses.replace(options, **kw)
    options = normalize_options(options, diffraction._backend(psi0.device))
    return run_impl(geometry, options, data, psi0, scan, prb0)
