"""The port's object-only CG solver against ``tikejax.solvers.run``.

Both packages solve the same problem (made once by the JAX package's
``make_problem`` in complex128 and handed over as numpy arrays). On the
oracle path the two run the same arithmetic in float64, so the
trajectories agree to 1e-8: per-iteration objective, iteration count, the
accept/reject pattern of the line search and the final object. The port's
merged path (every candidate evaluated by ``grad_fused``, here its plain
version) is held against JAX's classic backtracking: the two evaluate the
same candidates, the classic one through quadratic statistics, so they
agree to rounding (1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax.models import make_problem
from tikejax.ops import diffraction as jdiff
from tikejax.solvers import cg as jcg
from tikejax_torch.ops import fused
from tikejax_torch.solvers import cg as tcg
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


GEOM = tikejax.Geometry(nz=64, n=64, nscan=16, ndet=32, nprb=24)
ITERS = 20


@pytest.fixture(scope="module")
def problem():
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(0), GEOM,
                                             dtype=jnp.complex128)
    psi0 = np.ones(GEOM.psi_shape, np.complex128)
    return tuple(np.asarray(x) for x in (data, psi0, scan, prb, psi_true))


def run_both(problem, jax_kw, port_kw=None, psi0=None):
    data, p0, scan, prb, _ = problem
    p0 = p0 if psi0 is None else psi0
    pj, _, mj = jcg.run(*map(jnp.asarray, (data, p0, scan, prb)), GEOM,
                        **jax_kw)
    pt, prb_t, mt = tcg.run(*map(cpu, (data, p0, scan, prb)),
                            geometry_from(GEOM), **(port_kw or jax_kw))
    np.testing.assert_array_equal(to_numpy(prb_t), prb)
    return (np.asarray(pj), {k: np.asarray(v) for k, v in mj.items()},
            to_numpy(pt), {k: (to_numpy(v) if torch.is_tensor(v) else v)
                           for k, v in mt.items()})


def assert_same_trajectory(pj, mj, pt, mt, tol):
    n = int(mj["iters_run"])
    assert int(mt["iters_run"]) == n
    np.testing.assert_array_equal(mt["gamma"][:n] == 0, mj["gamma"][:n] == 0)
    for key in ("minf", "residual", "gamma", "grad_norm"):
        np.testing.assert_allclose(mt[key], mj[key], rtol=tol, atol=0,
                                   err_msg=key)
    np.testing.assert_array_equal(mt["gamma_prb"], 0.0)
    assert np.abs(pt - pj).max() <= tol * np.abs(pj).max()


@pytest.mark.parametrize("kw", [
    dict(),                                           # 'auto' -> interp
    dict(linesearch="backtracking"),
    dict(precondition="max", step_policy="track"),
    dict(precondition="none", adaptive_step=False, step0=0.5),
    dict(model="poisson"),
], ids=["interp", "backtracking", "max-track", "none-fixed", "poisson"])
def test_oracle_path_matches_jax(problem, kw):
    kw = dict(piter=ITERS, kernel="xla", **kw)
    assert_same_trajectory(*run_both(problem, kw), tol=1e-8)


@pytest.mark.parametrize("kernel, linesearch", [
    ("fused_mx", "backtracking"),  # the solver default on CUDA
    ("fused", "interp"),           # the single-pass tier resolves to interp
])
def test_merged_path_matches_jax_classic(problem, kernel, linesearch):
    pj, mj, pt, mt = run_both(
        problem, dict(piter=ITERS, kernel="xla", linesearch=linesearch),
        dict(piter=ITERS, kernel=kernel))
    assert_same_trajectory(pj, mj, pt, mt, tol=1e-7)
    # One grad_fused pass per candidate plus the initial gradient; one
    # host read per pass, one for sum(data) and one per interpolation.
    assert mt["evaluations"] >= ITERS + 1
    assert mt["host_syncs"] >= mt["evaluations"] + 1
    if linesearch == "interp":
        assert not np.all(np.log2(mt["gamma"]) % 1 == 0)  # it interpolated


def test_stop_on_stall(problem):
    """A line search that can only fail (one candidate, far too long)
    stops after stop_on_stall consecutive failures, as in JAX."""
    kw = dict(piter=ITERS, kernel="xla", step0=1e6, max_halvings=0,
              adaptive_step=False)
    pj, mj, pt, mt = run_both(problem, kw)
    assert int(mt["iters_run"]) == int(mj["iters_run"]) == 2
    np.testing.assert_array_equal(pt, problem[1])
    _, _, pt, mt = run_both(problem, kw, dict(kw, kernel="fused_mx"))
    assert int(mt["iters_run"]) == 2
    np.testing.assert_array_equal(pt, problem[1])


def test_target_residual(problem):
    kw = dict(piter=ITERS, kernel="xla", target_residual=0.05)
    pj, mj, pt, mt = run_both(problem, kw)
    n = int(mt["iters_run"])
    assert 1 < n < ITERS and n == int(mj["iters_run"])
    assert mt["residual"][n - 1] <= 0.05 < mt["residual"][n - 2]
    np.testing.assert_array_equal(mt["minf"][n:], 0.0)
    assert_same_trajectory(pj, mj, pt, mt, tol=1e-8)


def test_ported_options_mirror_jax():
    """Every field has the JAX package's name and default, and every JAX
    field is ported (the slab fields as a contract: validated, then the
    whole-object solve)."""
    jf = {f.name: f.default for f in dataclasses.fields(jcg.CGOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(tcg.CGOptions)}
    assert all(jf[k] == v for k, v in tf.items())
    assert set(jf) == set(tf)


@pytest.mark.parametrize("kw", [
    dict(precondition="illum_lowk"),
    dict(precondition="illum_lowk", lowk_boost=1.5, lowk_frac=0.2),
    dict(precondition="illum_lowk", direction="lbfgs"),
], ids=["defaults", "boost-frac", "lbfgs"])
def test_illum_lowk_matches_jax(problem, kw):
    """The low-frequency-boosted illumination preconditioner, on the
    oracle path in float64: the trajectory of the JAX package to 1e-8."""
    kw = dict(piter=ITERS, kernel="xla", **kw)
    pj, mj, pt, mt = run_both(problem, kw)
    assert_same_trajectory(pj, mj, pt, mt, tol=1e-8)
    plain = run_both(problem, dict(kw, precondition="illum"))[3]
    assert not np.allclose(plain["minf"], mt["minf"])  # the filter acted


def test_illum_lowk_validation(problem):
    """The JAX package's validity checks: object-only, boost >= 0, the
    crossover in (0, 0.5]."""
    data, psi0, scan, prb, _ = map(cpu, problem)
    g = geometry_from(GEOM)
    for kw, match in [(dict(recover_prb=True), "object-only"),
                      (dict(lowk_boost=-1.0), "lowk_boost"),
                      (dict(lowk_frac=0.0), "lowk_frac"),
                      (dict(lowk_frac=0.6), "lowk_frac")]:
        with pytest.raises(ValueError, match=match):
            tcg.run(data, psi0, scan, prb, g, piter=2, kernel="xla",
                    precondition="illum_lowk", **kw)
        with pytest.raises(ValueError, match=match):
            jcg.run(*map(jnp.asarray, problem[:4]), GEOM, piter=2,
                    kernel="xla", precondition="illum_lowk", **kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(direction="lbfgs"), dict(step0=4.0, adaptive_step=False),
], ids=["dy", "lbfgs", "long-fixed-step"])
def test_parabolic_linesearch_matches_jax(problem, kw):
    """linesearch='parabolic' (Gaussian: a Poisson run with backtracking
    drifts from the JAX package past 1e-8 on this problem), on the oracle
    path in float64 to 1e-8. The refinement costs at most two evaluations
    and two host reads per accepted search."""
    kw = dict(piter=ITERS, kernel="xla", linesearch="parabolic", **kw)
    pj, mj, pt, mt = run_both(problem, kw)
    assert_same_trajectory(pj, mj, pt, mt, tol=1e-8)
    back = run_both(problem, dict(kw, linesearch="backtracking"))[3]
    assert not np.allclose(back["gamma"], mt["gamma"])  # it refined
    extra = mt["evaluations"] - back["evaluations"]
    assert 0 < extra and mt["host_syncs"] - back["host_syncs"] == extra


def test_parabolic_runs_the_classic_body_on_a_fused_tier(problem):
    """'parabolic' switches the merged body off, as in the JAX package: on
    a fused tier every candidate and both refinement samples are
    minf_fused passes (here the plain version), and the trajectory is the
    oracle path's."""
    before = fused.minf_fused_reference.launches
    pj, mj, pt, mt = run_both(
        problem, dict(piter=ITERS, kernel="xla", linesearch="parabolic"),
        dict(piter=ITERS, kernel="fused_mx", linesearch="parabolic"))
    assert_same_trajectory(pj, mj, pt, mt, tol=1e-8)
    candidates = fused.minf_fused_reference.launches - before
    assert candidates == mt["evaluations"] - ITERS > ITERS


def test_verbose_every_prints(problem, capsys):
    """verbose_every=N prints iteration, minf and gamma every N iterations
    in the JAX package's format."""
    data, psi0, scan, prb, _ = map(cpu, problem)
    _, _, m = tcg.run(data, psi0, scan, prb, geometry_from(GEOM), piter=7,
                      kernel="xla", verbose_every=3)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for line, i in zip(lines, (0, 3, 6)):
        assert line == (f"iter {i}: minf={float(m['minf'][i]):.6e} "
                        f"gamma={float(m['gamma'][i]):.4f}")
    tcg.run(data, psi0, scan, prb, geometry_from(GEOM), piter=3,
            kernel="xla")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("kw", [
    dict(axis_name="scan"), dict(obj_axis_name="obj"), dict(obj_halo=3),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items())[:40])
def test_unported_options_raise(problem, kw):
    """The mesh axes name dimensions of a mesh, which only
    ``parallel.run_sharded`` (the scan and theta axes) and
    ``parallel.run_tiled`` (the object axis) supply; ``obj_halo`` without
    an object axis changes nothing, as in the JAX package. (The slab
    fields are ported as a contract: ``tests/test_torch_large.py``.)"""
    data, psi0, scan, prb, _ = map(cpu, problem)
    if "axis_name" in kw or "obj_axis_name" in kw:
        entry = "run_tiled" if "obj_axis_name" in kw else "run_sharded"
        with pytest.raises(ValueError, match=entry):
            tcg.run(data, psi0, scan, prb, geometry_from(GEOM), piter=2,
                    **kw)
        return
    psi, _, m = tcg.run(data, psi0, scan, prb, geometry_from(GEOM),
                        piter=2, kernel="xla", **kw)
    psi_1, _, m_1 = tcg.run(data, psi0, scan, prb, geometry_from(GEOM),
                            piter=2, kernel="xla")
    assert torch.equal(psi, psi_1) and torch.equal(m["minf"], m_1["minf"])


def test_unported_fields_at_default_run(problem):
    """The slab fields at their defaults (and any other field) run; an
    unknown keyword raises TypeError, as CGOptions does."""
    data, psi0, scan, prb, _ = map(cpu, problem)
    _, _, m = tcg.run(data, psi0, scan, prb, geometry_from(GEOM), piter=2,
                      fused_linesearch=False, obj_slabs=1, carry_state=False)
    assert int(m["iters_run"]) == 2
    with pytest.raises(TypeError):
        tcg.run(data, psi0, scan, prb, geometry_from(GEOM), no_such=1)


# -- the solver surface of reconstruct: L-BFGS, the split-operator
# f_base, carried state, the frameless non-merged body ---------------------

def run_pair(problem, jax_kw, port_kw, psi0=None, f_base=None,
             init=(None, None)):
    """Both solvers on the same problem; ``f_base`` (numpy) goes to both,
    ``init`` is (JAX cg_init, port cg_init)."""
    data, p0, scan, prb, _ = problem
    p0 = p0 if psi0 is None else psi0
    jb = None if f_base is None else jnp.asarray(f_base)
    tb = None if f_base is None else cpu(f_base)
    pj, _, mj = jcg.run(*map(jnp.asarray, (data, p0, scan, prb)), GEOM,
                        f_base=jb, cg_init=init[0], **jax_kw)
    pt, _, mt = tcg.run(*map(cpu, (data, p0, scan, prb)),
                        geometry_from(GEOM), f_base=tb, cg_init=init[1],
                        **port_kw)
    return pj, mj, pt, mt


def as_numpy(pj, mj, pt, mt):
    skip = ("cg_state",)
    return (np.asarray(pj), {k: np.asarray(v) for k, v in mj.items()
                             if k not in skip},
            to_numpy(pt), {k: (to_numpy(v) if torch.is_tensor(v) else v)
                           for k, v in mt.items() if k not in skip})


@pytest.fixture(scope="module")
def f_base(problem):
    """The farplane of an 8-iteration solve: the split-operator base."""
    data, psi0, scan, prb, _ = problem
    psi_b, _, _ = jcg.run(*map(jnp.asarray, (data, psi0, scan, prb)), GEOM,
                          piter=8, kernel="xla")
    return np.asarray(jdiff.fwd_raw(psi_b, jnp.asarray(scan),
                                    jnp.asarray(prb), GEOM.ndet, "xla"))


@pytest.mark.parametrize("direction", ["lbfgs", "lbfgs:4"])
def test_lbfgs_matches_jax(problem, direction):
    kw = dict(piter=ITERS, kernel="xla", direction=direction)
    assert_same_trajectory(*run_both(problem, kw), tol=1e-8)


@pytest.mark.parametrize("port_kw", [
    dict(kernel="xla"),
    dict(kernel="fused_mx"),
    dict(kernel="fused_mx", merged_linesearch="off", direction="lbfgs"),
    dict(kernel="fused", merged_linesearch="off"),
], ids=["xla", "merged", "frameless-lbfgs", "frameless-interp"])
def test_split_operator_matches_jax(problem, f_base, port_kw):
    """CG on a correction from zero with a frozen base farplane: every
    body of the port against JAX's oracle path with the same base."""
    ls = "interp" if port_kw["kernel"] in ("xla", "fused") else (
        "backtracking")
    jax_kw = dict(piter=ITERS, kernel="xla", linesearch=ls,
                  direction=port_kw.get("direction", "auto"))
    zero = np.zeros(GEOM.psi_shape, np.complex128)
    out = as_numpy(*run_pair(problem, jax_kw, dict(piter=ITERS, **port_kw),
                             psi0=zero, f_base=f_base))
    assert_same_trajectory(*out, tol=1e-8)


@pytest.mark.parametrize("kernel, linesearch", [
    ("fused_mx", "backtracking"), ("fused", "interp")])
def test_frameless_classic_body_matches_jax(problem, kernel, linesearch):
    """merged_linesearch='off' on a fused tier: one grad_fused pass per
    iteration and one minf_fused pass per line-search candidate."""
    before = fused.minf_fused_reference.launches
    pj, mj, pt, mt = run_both(
        problem, dict(piter=ITERS, kernel="xla", linesearch=linesearch),
        dict(piter=ITERS, kernel=kernel, merged_linesearch="off"))
    assert_same_trajectory(pj, mj, pt, mt, tol=1e-8)
    candidates = fused.minf_fused_reference.launches - before
    assert candidates == mt["evaluations"] - ITERS >= ITERS


@pytest.mark.parametrize("direction", ["dy", "lbfgs"])
def test_carried_state_continues_like_jax(problem, direction):
    """carry_state returns the terminal (d, g, gamma, gamma0); a second run
    seeded with it through cg_init continues the same trajectory."""
    kw = dict(piter=8, kernel="xla", direction=direction, carry_state=True)
    pj, mj, pt, mt = run_pair(problem, kw, kw)
    sj, st = mj["cg_state"], mt["cg_state"]
    assert len(st) == len(sj) == 4
    for a, b in zip(sj, st):
        np.testing.assert_allclose(to_numpy(b), np.asarray(a), rtol=1e-8,
                                   atol=1e-12)
    out = run_pair(problem, kw, kw, psi0=np.asarray(pj), init=(sj, st))
    assert_same_trajectory(*as_numpy(*out), tol=1e-8)
    # A carried state is not a fresh start.
    fresh = run_pair(problem, kw, kw, psi0=np.asarray(pj))
    assert not np.allclose(to_numpy(fresh[3]["minf"]),
                           to_numpy(out[3]["minf"]))


def test_carry_lbfgs_ring_matches_jax(problem):
    """carry_lbfgs implies carry_state and carries the (S, Y, sy, count)
    ring in the 8-tuple layout."""
    kw = dict(piter=8, kernel="xla", direction="lbfgs:4", carry_lbfgs=True)
    pj, mj, pt, mt = run_pair(problem, kw, kw)
    sj, st = mj["cg_state"], mt["cg_state"]
    assert len(st) == len(sj) == 8 and int(st[7]) == int(sj[7]) > 0
    for a, b in zip(sj, st):
        np.testing.assert_allclose(to_numpy(b), np.asarray(a), rtol=1e-8,
                                   atol=1e-12)
    out = run_pair(problem, kw, kw, psi0=np.asarray(pj), init=(sj, st))
    assert_same_trajectory(*as_numpy(*out), tol=1e-8)


@pytest.mark.parametrize("kw", [
    dict(direction="dy"), dict(direction="lbfgs:3", carry_lbfgs=True)])
def test_zero_cg_state_is_a_fresh_start(problem, kw):
    data, psi0, scan, prb, _ = map(cpu, problem)
    opts = tcg.normalize_options(tcg.CGOptions(piter=6, kernel="xla", **kw),
                                 "cpu")
    zero = tcg.zero_cg_state(psi0, opts)
    zj = jcg.zero_cg_state(jnp.asarray(problem[1]), jcg.normalize_options(
        jcg.CGOptions(piter=6, kernel="xla", **kw)))
    assert [tuple(z.shape) for z in zero] == [z.shape for z in zj]
    _, _, m0 = tcg.run(data, psi0, scan, prb, geometry_from(GEOM), opts)
    _, _, m1 = tcg.run(data, psi0, scan, prb, geometry_from(GEOM), opts,
                       cg_init=zero)
    torch.testing.assert_close(m1["minf"], m0["minf"], rtol=0, atol=0)


def test_solver_surface_validation(problem, f_base):
    data, psi0, scan, prb, _ = map(cpu, problem)
    g = geometry_from(GEOM)
    for direction in ("bfgs", "lbfgs:0", "lbfgs:x"):
        with pytest.raises(ValueError, match="direction|memory"):
            tcg.run(data, psi0, scan, prb, g, piter=2, direction=direction)
    with pytest.raises(ValueError, match="frameless split-operator"):
        tcg.run(data, psi0, scan, prb, g, piter=2, kernel="xla",
                memory="frameless", f_base=cpu(f_base))
    state = tcg.zero_cg_state(psi0, tcg.CGOptions(direction="lbfgs",
                                                  carry_lbfgs=True))
    with pytest.raises(ValueError, match="8-entry"):
        tcg.run(data, psi0, scan, prb, g, piter=2, kernel="xla",
                cg_init=state)
    with pytest.raises(ValueError, match="8-tuple"):
        tcg.run(data, psi0, scan, prb, g, piter=2, kernel="xla",
                direction="lbfgs", carry_lbfgs=True, cg_init=state[:4])


# -- more than one angle and more than one mode -----------------------------

GEOM2 = tikejax.Geometry(nz=48, n=48, nscan=16, ndet=32, nprb=16, ntheta=2,
                         nmodes=2)
ITERS2 = 12


@pytest.fixture(scope="module")
def problem2():
    _, scan, prb, data = make_problem(jax.random.PRNGKey(1), GEOM2,
                                      dtype=jnp.complex128)
    psi0 = np.ones(GEOM2.psi_shape, np.complex128)
    return tuple(np.asarray(x) for x in (data, psi0, scan, prb))


@pytest.mark.parametrize("jax_kw, port_kw, tol", [
    (dict(), None, 1e-8),
    (dict(model="poisson"), None, 1e-8),
    (dict(direction="lbfgs"), None, 1e-8),
    (dict(precondition="illum_lowk"), None, 1e-8),
    (dict(linesearch="backtracking"), dict(kernel="fused_mx"), 1e-7),
    (dict(linesearch="backtracking"),
     dict(kernel="fused_mx", memory="materialized"), 1e-8),
    (dict(), dict(kernel="pallas"), 1e-8),
], ids=["gaussian", "poisson", "lbfgs", "illum_lowk", "merged-fused_mx",
        "materialized", "pallas"])
def test_two_angles_two_modes_match_jax(problem2, jax_kw, port_kw, tol):
    """ntheta = 2, nmodes = 2 in float64: every object-only body of the
    port against the JAX package's oracle path, as the one-angle, one-mode
    cases above (the merged body to rounding, the others to 1e-8)."""
    jax_kw = dict(piter=ITERS2, kernel="xla", **jax_kw)
    port_kw = jax_kw if port_kw is None else dict(piter=ITERS2, **port_kw)
    data, psi0, scan, prb = problem2
    pj, _, mj = jcg.run(*map(jnp.asarray, problem2), GEOM2, **jax_kw)
    pt, prb_t, mt = tcg.run(*map(cpu, problem2), geometry_from(GEOM2),
                            **port_kw)
    np.testing.assert_array_equal(to_numpy(prb_t), prb)
    assert pt.shape == GEOM2.psi_shape
    assert_same_trajectory(*as_numpy(pj, mj, pt, mt), tol=tol)
