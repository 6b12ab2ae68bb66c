"""The port's reference-shaped facade against ``tikejax.compat``.

``tikejax_torch.compat.CGPtychoSolver`` and ``tikejax.compat.CGPtychoSolver``
get the same numpy arrays (made with the JAX package's ``make_problem`` and
numpy from seeds). Both facades take their arrays in as complex64 / float32,
so the two sides agree to fp32 rounding, not to 1e-8: operators 2e-6 of
their scale; eight-iteration objective trajectories 2e-4 relative (Gaussian
and Poisson, object-only and joint), the relative residual 2e-3 (the Poisson
residual is the root of a difference that cancels four digits of the fp32
objective), the returned object and probe 1e-3 of their scale. The float64 agreement of the engines underneath is held by the
solver test files. The port's facade runs on the CPU here (``device='cpu'``)
on the hybrid ``'pallas'`` tier (its kernels' plain versions) and on the
oracle; the JAX facade runs its oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax import compat as jcompat
from tikejax.models import make_problem
from tikejax_torch import compat as tcompat
from tikejax_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOM = tikejax.Geometry(nz=64, n=64, nscan=16, ndet=32, nprb=24)
DIMS = dict(ntheta=1, nz=64, n=64, nscan=16, ndet=32, nprb=24)
ITERS = 8


def crand(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def problem():
    """(data, psi0 = ones, scan, prb, probe perturbed at 3%), numpy."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(0), GEOM,
                                      dtype=jnp.complex64)
    prb = np.asarray(prb)
    rng = np.random.default_rng(7)
    prb_p = prb + 0.03 * np.abs(prb).max() * crand(rng, prb.shape)
    return (np.asarray(data), np.ones(GEOM.psi_shape, np.complex64),
            np.asarray(scan), prb, prb_p)


def facades(kernel="pallas", **dims):
    dims = dict(DIMS, **dims)
    return (jcompat.CGPtychoSolver(**dims, kernel="xla"),
            tcompat.CGPtychoSolver(**dims, kernel=kernel, device="cpu"))


def close(got, ref, tol):
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("kernel", ["pallas", "xla", "auto"])
def test_operators_match_jax_facade(problem, kernel):
    """fwd / adj / adj_probe: numpy in, numpy out, the JAX facade's values;
    a mode-less probe is accepted when nmodes == 1."""
    _, _, scan, prb, _ = problem
    rng = np.random.default_rng(1)
    psi = crand(rng, GEOM.psi_shape)
    farp = crand(rng, GEOM.farplane_shape)
    sj, st = facades(kernel)
    for name, args in (("fwd", (psi, scan, prb[:, 0])),
                       ("adj", (farp, scan, prb)),
                       ("adj_probe", (farp, scan, psi))):
        ref = getattr(sj, name)(*args)
        got = getattr(st, name)(*args)
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64
        assert got.shape == ref.shape
        assert close(got, ref, 2e-6), name


def test_adjoint_identity_through_the_facade(problem):
    """<G psi, f> = <psi, G^H f> = <prb, G_p^H f> to 1e-5 in complex64."""
    _, _, scan, prb, _ = problem
    rng = np.random.default_rng(2)
    psi = crand(rng, GEOM.psi_shape)
    farp = crand(rng, GEOM.farplane_shape)
    _, st = facades("pallas")
    lhs = np.vdot(st.fwd(psi, scan, prb), farp)
    assert abs(lhs - np.vdot(psi, st.adj(farp, scan, prb))) < 1e-5 * abs(lhs)
    assert abs(lhs - np.vdot(prb, st.adj_probe(farp, scan, psi))) < (
        1e-5 * abs(lhs))


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("recover_prb", [False, True],
                         ids=["object", "joint"])
def test_run_matches_jax_facade(problem, model, recover_prb):
    data, psi0, scan, prb, prb_p = problem
    start = prb_p if recover_prb else prb
    sj, st = facades("pallas")
    before = kernels.gather_probe_mul_reference.launches
    rj = sj.run(data, psi0, scan, start, piter=ITERS, model=model,
                recover_prb=recover_prb)
    rt = st.run(data, psi0, scan, start, piter=ITERS, model=model,
                recover_prb=recover_prb)
    assert kernels.gather_probe_mul_reference.launches > before
    assert set(rt) == set(rj) | {"host_syncs", "evaluations"}
    assert all(isinstance(v, np.ndarray) for v in rt.values())
    assert int(rt["iters_run"]) == int(rj["iters_run"]) == ITERS
    np.testing.assert_allclose(rt["minf"], rj["minf"], rtol=2e-4)
    np.testing.assert_allclose(rt["residual"], rj["residual"], rtol=2e-3)
    np.testing.assert_array_equal(rt["gamma"] == 0, rj["gamma"] == 0)
    np.testing.assert_array_equal(rt["gamma_prb"] == 0, rj["gamma_prb"] == 0)
    assert rt["psi"].dtype == rt["prb"].dtype == np.complex64
    assert close(rt["psi"], rj["psi"], 1e-3)
    assert close(rt["prb"], rj["prb"], 1e-3)
    assert rt["minf"][-1] < rt["minf"][0]
    if recover_prb:
        assert np.abs(rt["prb"] - start).max() > 0
    else:
        np.testing.assert_array_equal(rt["prb"], start)


def test_run_keywords_pass_through(problem, capsys):
    """Extra keywords are CGOptions fields, the constructor's kernel is the
    default and a ``kernel=`` keyword overrides it, as in the JAX facade."""
    data, psi0, scan, prb, _ = problem
    _, st = facades("pallas")
    before = kernels.gather_probe_mul_reference.launches
    out = st.run(data, psi0, scan, prb, piter=4, kernel="xla",
                 precondition="illum_lowk", linesearch="parabolic",
                 verbose_every=2)
    assert kernels.gather_probe_mul_reference.launches == before
    assert int(out["iters_run"]) == 4
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    with pytest.raises(TypeError):
        st.run(data, psi0, scan, prb, no_such_option=1)


def test_reconstruct_matches_jax_facade(problem):
    """The reconstruct dictionary: keys, stage names (with the tier's name)
    and, at fp32, a final residual under the target on both sides."""
    data, psi0, scan, prb, _ = problem
    kw = dict(target_residual=2e-3, segment=12, max_segments=12)
    sj, st = facades("pallas")
    rj = sj.reconstruct(data, psi0, scan, prb, tiers=(("xla", 5e-3, 96),),
                        **kw)
    rt = st.reconstruct(data, psi0, scan, prb, fast_kernel="pallas",
                        base_kernel="pallas",
                        tiers=(("pallas", 5e-3, 96),), **kw)
    assert set(rt) == set(rj) == {"psi", "prb", "residual_last",
                                  "iters_run", "stages"}
    assert isinstance(rt["psi"], np.ndarray) and isinstance(rt["prb"],
                                                            np.ndarray)
    assert isinstance(rt["iters_run"], int)
    assert isinstance(rt["residual_last"], float)
    assert rt["iters_run"] == sum(k for _, k in rt["stages"])
    assert [n for n, _ in rt["stages"]][:2] == ["pallas", "split:pallas"]
    assert [n for n, _ in rj["stages"]][:2] == ["xla", "split:xla"]
    # Stage 1 runs the same trajectory on both sides up to fp32 rounding.
    assert abs(rt["stages"][0][1] - rj["stages"][0][1]) <= 1
    assert rt["residual_last"] <= 2e-3 and rj["residual_last"] <= 2e-3
    np.testing.assert_array_equal(rt["prb"], prb)


def test_shape_and_scan_errors(problem):
    """The JAX facade's ingestion checks: shapes, and ``check_scan`` on a
    numpy scan; a tensor scan is taken as it is, as a device array is
    there."""
    data, psi0, scan, prb, _ = problem
    sj, st = facades("pallas")
    for solver in (sj, st):
        with pytest.raises(ValueError, match="psi shape"):
            solver.fwd(psi0[:, :-1], scan, prb)
        with pytest.raises(ValueError, match="prb shape"):
            solver.fwd(psi0, scan, prb[..., :-1])
        with pytest.raises(ValueError, match="scan shape"):
            solver.fwd(psi0, scan[:, :-1], prb)
        bad = scan.copy()
        bad[0, 3, 1] = GEOM.n - GEOM.nprb + 1
        with pytest.raises(ValueError, match="1 scan position"):
            solver.run(data, psi0, bad, prb, piter=1)
    np.testing.assert_array_equal(st.fwd(psi0, torch.from_numpy(scan.copy()), prb),
                                  st.fwd(psi0, scan, prb))
    with pytest.raises(ValueError, match="prb shape"):
        tcompat.CGPtychoSolver(**dict(DIMS, nmodes=2), device="cpu").fwd(
            psi0, scan, prb[:, 0])


def test_mesh_raises_and_device_defaults_to_the_card(problem):
    """``mesh=`` is ported (``tests/test_torch_sharding.py`` runs it on
    gloo ranks); anything but a DeviceMesh raises."""
    data, psi0, scan, prb, _ = problem
    _, st = facades("pallas")
    with pytest.raises(ValueError, match="DeviceMesh"):
        st.run(data, psi0, scan, prb, piter=1, mesh=object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        st.reconstruct(data, psi0, scan, prb, mesh=object())
    assert tcompat.CGPtychoSolver(**DIMS).device.type == "cuda"
    assert st.kernel == "pallas" and st.geometry.nprb == GEOM.nprb
    with pytest.raises(ValueError, match="unknown kernel"):
        tcompat.CGPtychoSolver(**DIMS, kernel="cufft")


# -- more than one angle and more than one mode -----------------------------

GEOM2 = tikejax.Geometry(nz=48, n=48, nscan=16, ndet=32, nprb=16, ntheta=2,
                         nmodes=2)
DIMS2 = dict(ntheta=2, nz=48, n=48, nscan=16, ndet=32, nprb=16, nmodes=2)


@pytest.mark.parametrize("recover_prb", [False, True],
                         ids=["object", "joint"])
def test_two_angles_two_modes_facade_matches_jax(recover_prb):
    """The facade at ntheta = 2, nmodes = 2 (complex64 in both packages,
    so the tolerances of the one-angle, one-mode cases): the operators and
    a Gaussian run on the hybrid tier against the JAX facade's oracle."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(6), GEOM2,
                                      dtype=jnp.complex64)
    data, scan, prb = (np.asarray(x) for x in (data, scan, prb))
    rng = np.random.default_rng(3)
    psi = crand(rng, GEOM2.psi_shape)
    farp = crand(rng, GEOM2.farplane_shape)
    sj, st = facades("pallas", **DIMS2)
    for name, args in (("fwd", (psi, scan, prb)), ("adj", (farp, scan, prb)),
                       ("adj_probe", (farp, scan, psi))):
        ref, got = getattr(sj, name)(*args), getattr(st, name)(*args)
        assert got.shape == ref.shape and close(got, ref, 2e-6), name
    start = prb + 0.03 * np.abs(prb).max() * crand(rng, prb.shape) if (
        recover_prb) else prb
    psi0 = np.ones(GEOM2.psi_shape, np.complex64)
    rj = sj.run(data, psi0, scan, start, piter=ITERS,
                recover_prb=recover_prb)
    rt = st.run(data, psi0, scan, start, piter=ITERS,
                recover_prb=recover_prb)
    assert int(rt["iters_run"]) == int(rj["iters_run"]) == ITERS
    np.testing.assert_allclose(rt["minf"], rj["minf"], rtol=2e-4)
    np.testing.assert_allclose(rt["residual"], rj["residual"], rtol=2e-3)
    assert rt["psi"].shape == GEOM2.psi_shape
    assert rt["prb"].shape == GEOM2.prb_shape
    assert close(rt["psi"], rj["psi"], 1e-3)
    assert close(rt["prb"], rj["prb"], 1e-3)
