"""The materialized memory mode and the fused line search of the port
against the JAX package.

Kernels (their plain versions on the CPU): ``fused.adj_residual``,
``fused.fwd_quad_stats`` and ``linesearch.ls_objectives`` against the JAX
oracle in complex128 at 1e-10, and against the Pallas kernels of
``pallas_fused`` / ``pallas_linesearch`` in interpret mode in complex64 at
their full-f32 'kara_hp' precision, under the fused parity bounds
(gradients and statistics 1e-4 of their scale, objectives 1e-5 relative).
ntheta = 2 and nmodes = 2, odd object sides, and the last position of the
last angle is a masked dummy (scan row < 0).

Solver: ``run(memory='materialized')`` on a fused tier runs the same math
as JAX's oracle body, so the fp64 trajectories agree to 1e-8 (object-only
and joint; joint runs stay short, the joint iteration being chaotic in the
object/probe scale). The fused line search takes the first accepted step of
the same candidates as backtracking. The problems here have no masked
positions: at a masked position the reference's line-search objectives
carry a data term that the gradient pass's objective leaves out
(``test_masked_position_quirk_is_the_references``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax.models import make_problem
from tikejax.ops import diffraction as jdiff
from tikejax.ops import pallas_fused, pallas_linesearch
from tikejax.models import likelihoods as jlik
from tikejax.solvers import cg as jcg
from tikejax.solvers import reconstruct as jreconstruct
from tikejax_torch.ops import fused, linesearch
from tikejax_torch.solvers import cg as tcg
from tikejax_torch.solvers import reconstruct
from tikejax_torch.utils import geometry_from, to_numpy, to_torch


def cpu(x):
    """The array as a CPU tensor: the bridge's default device is the card."""
    return to_torch(x, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KGEOM = tikejax.Geometry(nz=40, n=37, nscan=9, ndet=24, nprb=16, ntheta=2,
                         nmodes=2)
GEOM = tikejax.Geometry(nz=64, n=64, nscan=16, ndet=32, nprb=24)
ITERS = 20
K = 17  # max_halvings + 1 at the solver default
GAMMAS = 0.5 ** np.arange(K, dtype=np.float32)


def kernel_inputs(g, dtype, seed=1):
    """psi, a direction dpsi, data, int scan, prb, a probe direction and
    the farplane G psi; the data are intensities of another object, so the
    objectives and gradients are O(1)."""
    rng = np.random.default_rng(seed)

    def crand(shape, scale=1.0):
        return (scale * (rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape))).astype(dtype)

    psi, psi2, prb = (crand(g.psi_shape), crand(g.psi_shape),
                      crand(g.prb_shape))
    dpsi, dprb = crand(g.psi_shape, 0.1), crand(g.prb_shape, 0.1)
    scan = np.stack([rng.integers(0, g.nz - g.nprb + 1, g.scan_shape[:2]),
                     rng.integers(0, g.n - g.nprb + 1, g.scan_shape[:2])],
                    -1).astype(np.int32)
    far2 = np.asarray(jdiff.fwd_raw(psi2, scan.astype(np.float64), prb,
                                    g.ndet))
    data = np.sum(np.abs(far2)**2, axis=2).astype(np.real(psi).dtype)
    scan[-1, -1, 0] = -1
    fpsi = np.asarray(jdiff.fwd_raw(psi, scan.astype(np.float64), prb,
                                    g.ndet)).astype(dtype)
    return psi, dpsi, data, scan, prb, dprb, fpsi


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def direction_args(inputs, which):
    """(direction, probe) for fwd_quad_stats: the object direction with the
    probe, or the object with the probe direction."""
    psi, dpsi, _, _, prb, dprb, _ = inputs
    return (dpsi, prb) if which == "object" else (psi, dprb)


def jax_ls_objectives(fpsi, fd, data, gammas, model):
    """The TPU kernel's formulas (pallas_linesearch.py:44-62) on the JAX
    oracle's statistics: no epsilon for Gaussian, no mask."""
    a, b, c = jcg._quad_stats(jnp.asarray(fpsi), jnp.asarray(fd))
    d = jnp.maximum(jnp.asarray(data), 0.0)
    out = []
    for g in np.asarray(gammas, np.float32).tolist():
        inten = jnp.maximum(a + 2.0 * g * b + g * g * c, 0.0)
        if model == "gaussian":
            out.append(float(jnp.sum((jnp.sqrt(inten) - jnp.sqrt(d))**2)))
        else:
            out.append(float(jnp.sum(inten - d * jnp.log(inten + 1e-8))))
    return np.array(out)


# -- the three kernels' plain versions against the JAX oracle -----------------

@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_adj_residual_plain_matches_jax_oracle(model):
    """adj_residual = G^H(factor * far) over the unmasked positions, and
    the objective skipping the masked one."""
    _, _, data, scan, prb, _, far = kernel_inputs(KGEOM, np.complex128)
    minf_fn, resid_fn = jlik.get_model(model)
    grad_j = np.asarray(jdiff.adj_raw(resid_fn(far, data),
                                      scan.astype(np.float64), prb, KGEOM.nz,
                                      KGEOM.n))
    valid = scan[..., 0] >= 0
    minf_j = float(minf_fn(far[valid][None], data[valid][None]))
    grad_t, minf_t = fused.adj_residual(cpu(far), cpu(data), cpu(scan),
                                        cpu(prb), KGEOM.nz, KGEOM.n, model)
    assert grad_t.dtype == torch.complex128
    assert rel(to_numpy(grad_t), grad_j) < 1e-10
    assert abs(float(minf_t) - minf_j) < 1e-10 * abs(minf_j)


@pytest.mark.parametrize("which", ["object", "probe"])
def test_fwd_quad_stats_plain_matches_jax_oracle(which):
    inputs = kernel_inputs(KGEOM, np.complex128)
    scan, fpsi = inputs[3], inputs[6]
    x, p = direction_args(inputs, which)
    fd = jdiff.fwd_raw(x, scan.astype(np.float64), p, KGEOM.ndet)
    a_j, b_j, c_j = (np.asarray(v) for v in jcg._quad_stats(fpsi, fd))
    a_j = a_j * (scan[..., 0] >= 0)[..., None, None]
    got = fused.fwd_quad_stats(cpu(x), cpu(scan), cpu(p), cpu(fpsi))
    for name, t, j in zip("abc", got, (a_j, b_j, c_j)):
        assert t.dtype == torch.float64 and t.shape == KGEOM.data_shape
        assert rel(to_numpy(t), j) < 1e-10, name
    assert float(got[0][-1, -1].abs().max()) == 0.0  # the masked a


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_ls_objectives_plain_matches_jax_formulas(model):
    psi, dpsi, data, scan, prb, _, fpsi = kernel_inputs(KGEOM,
                                                        np.complex128)
    fd = np.asarray(jdiff.fwd_raw(dpsi, scan.astype(np.float64), prb,
                                  KGEOM.ndet))
    ref = jax_ls_objectives(fpsi, fd, data, GAMMAS, model)
    got = linesearch.ls_objectives(cpu(fpsi), cpu(fd), cpu(data),
                                   torch.from_numpy(GAMMAS), model)
    assert got.dtype == torch.float64 and got.shape == (K,)
    np.testing.assert_allclose(to_numpy(got), ref, rtol=1e-10, atol=0)


# -- against the interpret-mode Pallas kernels --------------------------------

@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_adj_residual_plain_matches_pallas_kernel(model):
    _, _, data, scan, prb, _, far = kernel_inputs(KGEOM, np.complex64)
    grad_p, minf_p = pallas_fused.adj_residual(
        jnp.asarray(far), jnp.asarray(data), jnp.asarray(scan),
        jnp.asarray(prb), KGEOM.nz, KGEOM.n, model, precision="kara_hp")
    grad_t, minf_t = fused.adj_residual(cpu(far), cpu(data), cpu(scan),
                                        cpu(prb), KGEOM.nz, KGEOM.n, model)
    assert grad_t.dtype == torch.complex64 and minf_t.dtype == torch.float32
    assert rel(to_numpy(grad_t), grad_p) <= 1e-4
    assert abs(float(minf_t) - float(minf_p)) <= 1e-5 * abs(float(minf_p))


@pytest.mark.parametrize("which", ["object", "probe"])
def test_fwd_quad_stats_plain_matches_pallas_kernel(which):
    inputs = kernel_inputs(KGEOM, np.complex64)
    scan, fpsi = inputs[3], inputs[6]
    x, p = direction_args(inputs, which)
    ref = pallas_fused.fwd_quad_stats(jnp.asarray(x), jnp.asarray(scan),
                                      jnp.asarray(p), jnp.asarray(fpsi),
                                      precision="kara_hp")
    got = fused.fwd_quad_stats(cpu(x), cpu(scan), cpu(p), cpu(fpsi))
    for name, t, j in zip("abc", got, ref):
        assert t.dtype == torch.float32
        assert rel(to_numpy(t), np.asarray(j)) <= 1e-4, name


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_ls_objectives_plain_matches_pallas_kernel(model):
    psi, dpsi, data, scan, prb, _, fpsi = kernel_inputs(KGEOM, np.complex64)
    fd = np.asarray(jdiff.fwd_raw(dpsi, scan.astype(np.float64), prb,
                                  KGEOM.ndet)).astype(np.complex64)
    ref = np.asarray(pallas_linesearch.ls_objectives(
        jnp.asarray(fpsi), jnp.asarray(fd), jnp.asarray(data),
        jnp.asarray(GAMMAS), model))
    got = linesearch.ls_objectives(cpu(fpsi), cpu(fd), cpu(data), GAMMAS,
                                   model)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), ref, rtol=1e-5, atol=0)


def test_cpu_runs_the_plain_versions():
    """CPU tensors go to the *_reference functions and never count a
    kernel launch."""
    psi, dpsi, data, scan, prb, _, fpsi = map(
        cpu, kernel_inputs(KGEOM, np.complex64))
    kernels = [fused.adj_residual, fused.fwd_quad_stats,
               linesearch.ls_objectives]
    plain = [fused.adj_residual_reference, fused.fwd_quad_stats_reference,
             linesearch.ls_objectives_reference]
    k0, p0 = [f.launches for f in kernels], [f.launches for f in plain]
    fused.adj_residual(fpsi, data, scan, prb, KGEOM.nz, KGEOM.n, "poisson",
                       precision="bf16")
    fused.fwd_quad_stats(dpsi, scan, prb, fpsi, precision="kara_x3")
    linesearch.ls_objectives(fpsi, fpsi, data, [1.0, 0.5], "gaussian")
    assert [f.launches for f in kernels] == k0
    assert [f.launches - b for f, b in zip(plain, p0)] == [1, 1, 1]


def test_masked_position_quirk_is_the_references():
    """At a masked position with non-zero data the reference's gradient
    pass leaves the position out of its objective (adj_residual), while its
    line-search objectives count it: the quadratic statistics mask only
    ``a``, which leaves (sqrt(1e-12) - sqrt(d))^2 a pixel, and
    ls_objectives masks nothing (d a Gaussian pixel). The interpret-mode
    Pallas kernels show it; the port's plain versions keep it."""
    psi, dpsi, data, scan, prb, _, fpsi = kernel_inputs(KGEOM, np.complex64)
    masked = float(np.sum(np.sqrt(data[-1, -1].astype(np.float64))**2))
    assert masked > 1.0
    _, f0_p = pallas_fused.adj_residual(
        jnp.asarray(fpsi), jnp.asarray(data), jnp.asarray(scan),
        jnp.asarray(prb), KGEOM.nz, KGEOM.n, "gaussian", precision="kara_hp")
    a, b, c = pallas_fused.fwd_quad_stats(
        jnp.asarray(dpsi), jnp.asarray(scan), jnp.asarray(prb),
        jnp.asarray(fpsi), precision="kara_hp")
    quad0_p = float(jcg._minf_of_gamma("gaussian", a, b, c,
                                       jnp.asarray(data), 0.0))
    ls0_p = float(pallas_linesearch.ls_objectives(
        jnp.asarray(fpsi), jnp.asarray(fpsi) * 0, jnp.asarray(data),
        jnp.zeros(1, jnp.float32), "gaussian")[0])
    for excess in (quad0_p - float(f0_p), ls0_p - float(f0_p)):
        assert abs(excess - masked) <= 1e-4 * masked
    # The port: the same three numbers from its plain versions.
    t = [cpu(x) for x in (fpsi, data, scan, prb, dpsi)]
    _, f0_t = fused.adj_residual(t[0], t[1], t[2], t[3], KGEOM.nz, KGEOM.n,
                                 "gaussian")
    a, b, c = fused.fwd_quad_stats(t[4], t[2], t[3], t[0])
    quad0_t = float(tcg._minf_of_gamma("gaussian", a, b, c, t[1], 0.0))
    ls0_t = float(linesearch.ls_objectives(t[0], t[0] * 0, t[1], [0.0],
                                           "gaussian")[0])
    for got, ref in ((f0_t, f0_p), (quad0_t, quad0_p), (ls0_t, ls0_p)):
        assert abs(float(got) - ref) <= 1e-5 * abs(ref)


# -- the solver ---------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    _, scan, prb, data = make_problem(jax.random.PRNGKey(0), GEOM,
                                      dtype=jnp.complex128)
    prb = np.asarray(prb)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal(prb.shape) + 1j * rng.standard_normal(
        prb.shape)
    return (np.asarray(data), np.ones(GEOM.psi_shape, np.complex128),
            np.asarray(scan), prb, prb + 0.03 * np.abs(prb).max() * noise)


def run_jax(problem, **kw):
    data, psi0, scan, prb, prb_p = problem
    p0 = prb_p if kw.get("recover_prb") else prb
    pj, prj, mj = jcg.run(*map(jnp.asarray, (data, psi0, scan, p0)), GEOM,
                          **kw)
    return (np.asarray(pj), np.asarray(prj),
            {k: np.asarray(v) for k, v in mj.items()})


def run_port(problem, **kw):
    data, psi0, scan, prb, prb_p = problem
    p0 = prb_p if kw.get("recover_prb") else prb
    pt, prt, mt = tcg.run(*map(cpu, (data, psi0, scan, p0)),
                          geometry_from(GEOM), **kw)
    return (to_numpy(pt), to_numpy(prt),
            {k: (to_numpy(v) if torch.is_tensor(v) else v)
             for k, v in mt.items()})


def assert_same_trajectory(ref, got, tol):
    (pj, prj, mj), (pt, prt, mt) = ref, got
    n = int(mj["iters_run"])
    assert int(mt["iters_run"]) == n
    for key in ("gamma", "gamma_prb"):
        np.testing.assert_array_equal(mt[key][:n] == 0, mj[key][:n] == 0)
    for key in ("minf", "residual", "gamma", "gamma_prb", "grad_norm"):
        np.testing.assert_allclose(mt[key], mj[key], rtol=tol, atol=0,
                                   err_msg=key)
    assert np.abs(pt - pj).max() <= tol * np.abs(pj).max()
    assert np.abs(prt - prj).max() <= tol * np.abs(prj).max()


def counts(fns):
    return [f.launches for f in fns]


MATERIALIZED = [fused.fwd_reference, fused.adj_residual_reference,
                fused.fwd_quad_stats_reference, fused.adj_probe_reference,
                linesearch.ls_objectives_reference,
                fused.grad_fused_reference, fused.minf_fused_reference,
                fused.grad_prb_fused_reference]


@pytest.mark.parametrize("kernel, model, joint, piter", [
    ("fused_mx", "gaussian", False, ITERS),
    ("fused", "poisson", False, ITERS),        # 'interp' on this tier
    ("fused", "gaussian", False, ITERS),
    ("fused_mx", "gaussian", True, 16),
    ("fused_mx", "poisson", True, 16),
], ids=["gaussian", "poisson-interp", "interp", "joint-gaussian",
        "joint-poisson"])
def test_materialized_run_matches_jax(problem, kernel, model, joint, piter):
    """run(memory='materialized') on a fused tier: per object step one fwd,
    one adj_residual and one fwd_quad_stats; per probe step one fwd, one
    adj_probe and one fwd_quad_stats -- against JAX's oracle body."""
    ls = "interp" if kernel == "fused" else "backtracking"
    kw = dict(piter=piter, model=model, recover_prb=joint, linesearch=ls)
    before = counts(MATERIALIZED)
    got = run_port(problem, kernel=kernel, memory="materialized", **kw)
    fwd, adj_res, quad, adj_prb, ls_all, grad, minf, grad_prb = (
        a - b for a, b in zip(counts(MATERIALIZED), before))
    # The same arithmetic as the port's oracle body, to the last bit here.
    assert_same_trajectory(run_port(problem, kernel="xla", **kw), got,
                           tol=1e-12)
    assert_same_trajectory(run_jax(problem, kernel="xla", **kw), got,
                           tol=1e-8)
    steps = 2 if joint else 1
    assert adj_res == piter and adj_prb == (piter if joint else 0)
    assert fwd == quad == steps * piter
    assert ls_all == grad == minf == grad_prb == 0


@pytest.mark.parametrize("joint", [False, True], ids=["object", "joint"])
def test_xla_materialized_is_the_xla_run(problem, joint):
    """'xla' has no frameless path: memory='materialized' (and the fused
    line search, which needs a fused tier) changes nothing there."""
    kw = dict(piter=ITERS, kernel="xla", recover_prb=joint)
    ref = run_port(problem, **kw)
    for extra in (dict(memory="materialized"),
                  dict(memory="materialized", fused_linesearch=True)):
        got = run_port(problem, **kw, **extra)
        assert_same_trajectory(ref, got, tol=0)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_fused_linesearch_matches_backtracking(problem, model):
    """The JAX package's own comparison (tests/test_cg.py
    test_fused_linesearch_option): the one-pass search against the
    materialized backtracking run -- here both in fp64, and the candidate
    steps are the same powers of two, so the trajectories agree to 1e-8.
    One ls_objectives pass, one host read and two fwd passes (G psi, G d)
    an iteration; no fwd_quad_stats."""
    kw = dict(piter=ITERS, kernel="fused_mx", memory="materialized",
              model=model)
    ref = run_port(problem, **kw)
    before = counts(MATERIALIZED)
    got = run_port(problem, fused_linesearch=True, **kw)
    fwd, adj_res, quad, _, ls_all, _, _, _ = (
        a - b for a, b in zip(counts(MATERIALIZED), before))
    assert_same_trajectory(ref, got, tol=1e-8)
    assert ls_all == adj_res == ITERS and fwd == 2 * ITERS and quad == 0
    m = got[2]
    assert m["evaluations"] == 2 * ITERS
    # sum(data) (and the Poisson offset) at the start, then the objective
    # and the K values an iteration.
    start = 1 if model == "gaussian" else 2
    assert m["host_syncs"] == start + 2 * ITERS


def test_line_search_all_takes_the_first_accepted_step():
    """line_search_all returns the first of {gamma0 * shrink^k} whose
    objective is <= f0 (the candidate set backtracking walks), 0 if none;
    one evaluation and one host read a call."""
    _, _, data, _, _, _, fpsi = kernel_inputs(KGEOM, np.complex128)
    fd = -fpsi  # I(gamma) = (1 - gamma)^2 |fpsi|^2: not monotone in gamma
    opts = tcg.CGOptions(kernel="fused_mx", memory="materialized",
                         fused_linesearch=True, max_halvings=6)
    eng = tcg._Engine(geometry_from(KGEOM), opts, "cpu")
    assert eng.fused_linesearch and not eng.merged
    gammas = 3.0 * 0.5 ** np.arange(7)
    args = tuple(cpu(x) for x in (fpsi, fd, data))
    values = to_numpy(linesearch.ls_objectives(*args, gammas, "gaussian"))
    assert len(set(np.sign(np.diff(values)))) == 2  # not monotone
    for f0 in list(values) + [values.min() * (1 - 1e-6)]:
        first = next((g for g, f in zip(gammas, values) if f <= f0), 0.0)
        syncs, evals = eng.syncs, eng.evaluations
        assert eng.line_search_all(*args, f0, 3.0) == float(first)
        assert (eng.syncs - syncs, eng.evaluations - evals) == (1, 1)


def test_fused_linesearch_matches_jax_interpret():
    """Four iterations of JAX run(kernel='fused_hp', memory='materialized',
    fused_linesearch=True) -- fwd, adj_residual and ls_objectives in
    interpret mode, complex64 -- against the port's same run: the same
    steps, and objectives within the two fp32 implementations' spread
    (1e-6 at the start, ~3e-5 after the first steps: kara_hp's operator
    error is ~4e-7 and the objective falls 40-fold in one step)."""
    g = tikejax.Geometry(nz=48, n=48, nscan=9, ndet=24, nprb=16)
    _, scan, prb, data = make_problem(jax.random.PRNGKey(2), g)
    psi0 = np.ones(g.psi_shape, np.complex64)
    kw = dict(piter=4, kernel="fused_hp", memory="materialized",
              fused_linesearch=True)
    _, _, mj = jcg.run(data, jnp.asarray(psi0), scan, prb, g, **kw)
    before = linesearch.ls_objectives_reference.launches
    _, _, mt = tcg.run(*map(cpu, (data, psi0, scan, prb)), geometry_from(g),
                       **kw)
    assert linesearch.ls_objectives_reference.launches - before == 4
    np.testing.assert_array_equal(to_numpy(mt["gamma"]),
                                  np.asarray(mj["gamma"]))
    np.testing.assert_allclose(to_numpy(mt["minf"]), np.asarray(mj["minf"]),
                               rtol=1e-4)


def test_fused_linesearch_switches_the_merged_body_off(problem):
    """On the frameless tier fused_linesearch only switches the merged
    body off, as in the JAX package: one grad_fused pass an iteration and
    one minf_fused pass a candidate. Streamed (nchunks=2) it never runs
    ls_objectives either."""
    kw = dict(piter=ITERS, kernel="fused_mx")
    ref = run_port(problem, merged_linesearch="off", **kw)
    before = counts(MATERIALIZED)
    got = run_port(problem, fused_linesearch=True, **kw)
    _, _, _, _, ls_all, grad, minf, _ = (
        a - b for a, b in zip(counts(MATERIALIZED), before))
    assert_same_trajectory(ref, got, tol=0)
    assert grad == ITERS and minf == got[2]["evaluations"] - ITERS >= ITERS
    assert ls_all == 0
    streamed = dict(kw, nchunks=2, memory="materialized")
    before = counts(MATERIALIZED)
    got = run_port(problem, fused_linesearch=True, **streamed)
    fwd, adj_res, quad, _, ls_all, grad, minf, _ = (
        a - b for a, b in zip(counts(MATERIALIZED), before))
    assert_same_trajectory(run_port(problem, **streamed), got, tol=0)
    assert ls_all == adj_res == quad == grad == minf == 0 and fwd > 0


@pytest.mark.parametrize("extra", [
    dict(),
    dict(fused_linesearch=True, linesearch="backtracking"),
], ids=["quad-stats", "fused-linesearch"])
def test_materialized_reconstruct_matches_jax(extra):
    """reconstruct(memory='materialized') with fused tiers (their plain
    versions: fwd + adj_residual gradients, fwd_quad_stats line searches
    or one ls_objectives pass each, the base from fused.fwd) against JAX's
    reconstruct on the oracle tiers with the same options, stage for stage
    (on 'xla' JAX ignores fused_linesearch; its backtracking walks the
    same candidates)."""
    g = tikejax.Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)
    _, scan, prb, data = make_problem(jax.random.PRNGKey(3), g,
                                      dtype=jnp.complex128)
    prob = [np.asarray(x) for x in (data, np.ones(g.psi_shape,
                                                 np.complex128), scan, prb)]
    kw = dict(target_residual=3e-5, segment=12, max_segments=30,
              memory="materialized", **extra)
    _, _, sj = jreconstruct(*map(jnp.asarray, prob), g,
                            tiers=(("xla", 5e-3, 96),), **kw)
    before = [fused.adj_residual_reference.launches,
              linesearch.ls_objectives_reference.launches]
    _, _, st = reconstruct(*map(cpu, prob), geometry_from(g),
                           tiers=(("fused", 5e-3, 96),), fast_kernel="fused",
                           base_kernel="fused_hp", **kw)
    assert [n.replace("fused", "xla") for n, _ in st] == [n for n, _ in sj]
    for (name, mj), (_, mt) in zip(sj, st):
        assert int(mt["iters_run"]) == int(mj["iters_run"]), name
        np.testing.assert_allclose(to_numpy(mt["residual"]),
                                   np.asarray(mj["residual"]), rtol=1e-8,
                                   atol=0, err_msg=name)
    iters = sum(int(m["iters_run"]) for _, m in st)
    assert [fused.adj_residual_reference.launches - before[0],
            linesearch.ls_objectives_reference.launches - before[1]] == [
        iters, iters if extra else 0]
