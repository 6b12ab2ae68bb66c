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
import torch

import tikejax
from tikejax.models import make_problem
from tikejax.solvers import cg as jcg
from tikejax_torch.solvers import cg as tcg
from tikejax_torch.utils import geometry_from, to_numpy, to_torch

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
    pt, prb_t, mt = tcg.run(*map(to_torch, (data, p0, scan, prb)),
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
    """Every ported field has the JAX package's name and default; every
    other JAX field is listed as unported with its JAX default."""
    jf = {f.name: f.default for f in dataclasses.fields(jcg.CGOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(tcg.CGOptions)}
    assert all(jf[k] == v for k, v in tf.items())
    assert set(jf) == set(tf) | set(tcg._UNPORTED_FIELDS)
    assert all(jf[k] == v for k, v in tcg._UNPORTED_FIELDS.items())


@pytest.mark.parametrize("kw", [
    dict(recover_prb=True), dict(nchunks=2), dict(direction="lbfgs"),
    dict(direction="lbfgs:4"), dict(carry_state=True),
    dict(memory="materialized"), dict(fused_linesearch=True),
    dict(precondition="illum_lowk"), dict(axis_name="scan"),
    dict(obj_slabs=2), dict(linesearch="parabolic"), dict(kernel="pallas"),
    dict(kernel="fused_mx", merged_linesearch="off"),
    dict(f_base=np.zeros(1)), dict(cg_init=(0, 0, 0, 0)),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items())[:40])
def test_unported_options_raise(problem, kw):
    data, psi0, scan, prb, _ = map(to_torch, problem)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcg.run(data, psi0, scan, prb, geometry_from(GEOM), piter=2, **kw)


def test_unported_fields_at_default_run(problem):
    data, psi0, scan, prb, _ = map(to_torch, problem)
    _, _, m = tcg.run(data, psi0, scan, prb, geometry_from(GEOM), piter=2,
                      recover_prb=False, nchunks=1, carry_state=False)
    assert int(m["iters_run"]) == 2
    with pytest.raises(TypeError):
        tcg.run(data, psi0, scan, prb, geometry_from(GEOM), no_such=1)
