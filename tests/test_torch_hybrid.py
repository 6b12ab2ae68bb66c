"""The port's hybrid ``kernel='pallas'`` tier against the JAX package.

``tikejax_torch.ops.kernels`` holds the three patch kernels of the tier
(``gather_probe_mul``, ``scatter_conj_probe``, ``adj_probe_reduce``); on the
CPU each runs its plain PyTorch version. Inputs are made with numpy from a
seed and handed to both packages.

* The plain versions against the JAX package's Pallas kernels
  (``tikejax.ops.pallas_kernels``, in interpret mode on the CPU) in
  complex64: 1e-6 of the result's scale (both sides are fp32 and sum in
  different orders), at geometries with ``ndet > nprb``, two angles, 2-4
  modes and a masked position. The adjoints get the crop of larger frames
  as a strided view, as the operators hand it to them.
* The ``'pallas'`` operators against the port's ``'xla'`` oracle operators
  in complex128: 1e-12.
* ``run(kernel='pallas')`` against ``tikejax.solvers.run(kernel='xla')`` in
  float64: 1e-8. The hybrid tier is the oracle's arithmetic, and the JAX
  package's own ``'pallas'`` returns complex64 from complex128 inputs, so it
  cannot serve as the float64 reference; one short complex64 run is held to
  it at 2e-4 (fp32 rounding over eight iterations).
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
from tikejax.ops import pallas_kernels as jkern
from tikejax.solvers import cg as jcg
from tikejax.solvers import reconstruct as jreconstruct
from tikejax_torch.ops import diffraction as tdiff
from tikejax_torch.ops import kernels
from tikejax_torch.solvers import cg as tcg
from tikejax_torch.solvers import reconstruct
from tikejax_torch.utils import geometry_from, to_numpy, to_torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu(x):
    """The array as a CPU tensor: the bridge's default device is the card."""
    return to_torch(np.asarray(x), device="cpu")


GEOMS = [
    tikejax.Geometry(nz=48, n=40, nscan=7, ndet=24, nprb=16, ntheta=2,
                     nmodes=2),
    tikejax.Geometry(nz=40, n=44, nscan=5, ndet=32, nprb=20, ntheta=2,
                     nmodes=4),  # probe side not a multiple of 8
    tikejax.Geometry(nz=36, n=36, nscan=6, ndet=16, nprb=16, nmodes=3),
]


def crand(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def make_inputs(g, dtype, seed=0):
    """psi, integer scan offsets (the last position of the last angle a
    masked dummy), prb and frames (t, s, m, ndet, ndet), numpy."""
    rng = np.random.default_rng(seed)
    psi = crand(rng, g.psi_shape, dtype)
    prb = crand(rng, g.prb_shape, dtype)
    frames = crand(rng, g.farplane_shape, dtype)
    scan_i = np.stack([
        rng.integers(0, g.nz - g.nprb + 1, (g.ntheta, g.nscan)),
        rng.integers(0, g.n - g.nprb + 1, (g.ntheta, g.nscan)),
    ], -1).astype(np.int32)
    scan_i[-1, -1, 0] = -1
    return psi, scan_i, prb, frames


def close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


# -- the three kernels' plain versions against interpret-mode Pallas -------

@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_gather_probe_mul_matches_pallas(g):
    psi, scan_i, prb, _ = make_inputs(g, np.complex64)
    ref = jkern.gather_probe_mul(jnp.asarray(psi), jnp.asarray(scan_i),
                                 jnp.asarray(prb))
    before = kernels.gather_probe_mul_reference.launches
    got = kernels.gather_probe_mul(cpu(psi), cpu(scan_i), cpu(prb))
    assert kernels.gather_probe_mul_reference.launches == before + 1
    assert got.dtype == torch.complex64
    assert got.shape == (g.ntheta, g.nscan, g.nmodes, g.nprb, g.nprb)
    assert close(to_numpy(got), ref, 1e-6)
    np.testing.assert_array_equal(to_numpy(got)[-1, -1], 0.0)  # masked


@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_scatter_conj_probe_matches_pallas(g):
    _, scan_i, prb, frames = make_inputs(g, np.complex64)
    near = frames[..., :g.nprb, :g.nprb]
    ref = jkern.scatter_conj_probe(jnp.asarray(near), jnp.asarray(scan_i),
                                   jnp.asarray(prb), g.nz, g.n)
    view = cpu(frames)[..., :g.nprb, :g.nprb]  # strided when ndet > nprb
    assert view.is_contiguous() == (g.ndet == g.nprb)
    got = kernels.scatter_conj_probe(view, cpu(scan_i), cpu(prb), g.nz, g.n)
    assert got.dtype == torch.complex64 and got.shape == g.psi_shape
    assert close(to_numpy(got), ref, 1e-6)


@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_adj_probe_reduce_matches_pallas(g):
    psi, scan_i, _, frames = make_inputs(g, np.complex64)
    near = frames[..., :g.nprb, :g.nprb]
    ref = jkern.adj_probe_reduce(jnp.asarray(near), jnp.asarray(scan_i),
                                 jnp.asarray(psi))
    got = kernels.adj_probe_reduce(cpu(frames)[..., :g.nprb, :g.nprb],
                                   cpu(scan_i), cpu(psi))
    assert got.dtype == torch.complex64 and got.shape == g.prb_shape
    assert close(to_numpy(got), ref, 1e-6)


def test_masked_frames_are_ignored_by_the_adjoints():
    """The contract of the JAX package's test_sentinel_masked_positions:
    whatever a masked position's frames hold, the adjoints add nothing."""
    g = GEOMS[0]
    psi, scan_i, prb, frames = make_inputs(g, np.complex128)
    near = cpu(frames)[..., :g.nprb, :g.nprb]
    other = near.clone()
    other[-1, -1] = 1e6
    for a, b in (
            (kernels.scatter_conj_probe(near, cpu(scan_i), cpu(prb), g.nz,
                                        g.n),
             kernels.scatter_conj_probe(other, cpu(scan_i), cpu(prb), g.nz,
                                        g.n)),
            (kernels.adj_probe_reduce(near, cpu(scan_i), cpu(psi)),
             kernels.adj_probe_reduce(other, cpu(scan_i), cpu(psi)))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the 'pallas' operators against the oracle, complex128 ------------------

@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_pallas_operators_match_oracle(g):
    psi, scan_i, prb, farp = map(cpu, make_inputs(g, np.complex128))
    scan = scan_i.to(torch.float64)
    for got, ref in (
            (tdiff.fwd_raw(psi, scan, prb, g.ndet, "pallas"),
             tdiff.fwd_raw(psi, scan, prb, g.ndet, "xla")),
            (tdiff.adj_raw(farp, scan, prb, g.nz, g.n, "pallas"),
             tdiff.adj_raw(farp, scan, prb, g.nz, g.n, "xla")),
            (tdiff.adj_probe_raw(farp, scan, psi, g.nprb, "pallas"),
             tdiff.adj_probe_raw(farp, scan, psi, g.nprb, "xla"))):
        assert got.dtype == torch.complex128
        assert close(to_numpy(got), to_numpy(ref), 1e-12)


@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_pallas_hermitian_pairs(g):
    """<G psi, f> = <psi, G^H f> = <prb, G_p^H f> on the hybrid tier."""
    psi, scan_i, prb, farp = map(cpu, make_inputs(g, np.complex128))
    op = tdiff.Ptycho(geometry_from(g), kernel="pallas")
    lhs = torch.vdot(op.fwd(psi, scan_i, prb).reshape(-1), farp.reshape(-1))
    rhs = torch.vdot(psi.reshape(-1), op.adj(farp, scan_i, prb).reshape(-1))
    rhs_p = torch.vdot(prb.reshape(-1),
                       op.adj_probe(farp, scan_i, psi).reshape(-1))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12
    assert abs(lhs - rhs_p) / abs(lhs) < 1e-12


def test_pallas_autograd_matches_conj_jax_grad():
    """PyTorch's gradient of a real loss through ``fwd(kernel='pallas')``
    runs the tier's own adjoints and is the conjugate of ``jax.grad``
    through ``tikejax.ops.fwd`` (JAX's vjp is the unconjugated transpose)."""
    g = GEOMS[1]
    psi, scan_i, prb, farp = make_inputs(g, np.complex128)
    scan = scan_i.astype(np.float64)

    def loss_j(ps, pr):
        r = jdiff.fwd(ps, jnp.asarray(scan), pr, g.ndet, "xla") - farp
        return 0.5 * jnp.sum(jnp.abs(r)**2)

    dpsi_j, dprb_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(psi),
                                                      jnp.asarray(prb))
    ps, pr = cpu(psi).requires_grad_(), cpu(prb).requires_grad_()
    counts = [kernels.scatter_conj_probe_reference.launches,
              kernels.adj_probe_reduce_reference.launches]
    r = tdiff.fwd(ps, cpu(scan), pr, g.ndet, "pallas") - cpu(farp)
    (0.5 * torch.sum(r.abs()**2)).backward()
    assert [kernels.scatter_conj_probe_reference.launches,
            kernels.adj_probe_reduce_reference.launches] == [
                c + 1 for c in counts]
    assert close(to_numpy(ps.grad), np.conj(np.asarray(dpsi_j)), 1e-10)
    assert close(to_numpy(pr.grad), np.conj(np.asarray(dprb_j)), 1e-10)


def test_plain_versions_take_any_strides():
    """The plain versions take any dtype and strides (to rounding: a sum
    over strided memory may run in another order); the type and stride
    checks belong to the CUDA path, which never falls back."""
    g = GEOMS[2]
    psi, scan_i, prb, frames = map(cpu, make_inputs(g, np.complex128))
    swapped = frames.transpose(-1, -2)  # innermost stride != 1
    assert close(kernels.adj_probe_reduce(swapped, scan_i, psi),
                 kernels.adj_probe_reduce(swapped.contiguous(), scan_i, psi),
                 1e-13)
    assert close(kernels.scatter_conj_probe(swapped, scan_i, prb, g.nz, g.n),
                 kernels.scatter_conj_probe(swapped.contiguous(), scan_i, prb,
                                            g.nz, g.n), 1e-13)


# -- the solver on the hybrid tier ------------------------------------------

GEOM = tikejax.Geometry(nz=64, n=64, nscan=16, ndet=32, nprb=24)
ITERS = 16


@pytest.fixture(scope="module")
def problem():
    """(data, psi0 = ones, scan, prb, probe perturbed at 3%), complex128."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(0), GEOM,
                                      dtype=jnp.complex128)
    prb = np.asarray(prb)
    rng = np.random.default_rng(7)
    prb_p = prb + 0.03 * np.abs(prb).max() * crand(rng, prb.shape,
                                                   np.complex128)
    return (np.asarray(data), np.ones(GEOM.psi_shape, np.complex128),
            np.asarray(scan), prb, prb_p)


def run_both(problem, kw, joint=False, f_base=None, psi0=None):
    """JAX on 'xla', the port on 'pallas', the same problem and options;
    returns (psi, prb, metrics) of each as numpy."""
    data, p0, scan, prb, prb_p = problem
    p0 = p0 if psi0 is None else psi0
    prb = prb_p if joint else prb
    jb = None if f_base is None else jnp.asarray(f_base)
    tb = None if f_base is None else cpu(f_base)
    pj, qj, mj = jcg.run(*map(jnp.asarray, (data, p0, scan, prb)), GEOM,
                         kernel="xla", f_base=jb, **kw)
    pt, qt, mt = tcg.run(*map(cpu, (data, p0, scan, prb)),
                         geometry_from(GEOM), kernel="pallas", f_base=tb,
                         **kw)
    return ((np.asarray(pj), np.asarray(qj),
             {k: np.asarray(v) for k, v in mj.items()}),
            (to_numpy(pt), to_numpy(qt),
             {k: (to_numpy(v) if torch.is_tensor(v) else v)
              for k, v in mt.items()}))


def assert_same_trajectory(jax_out, port_out, tol=1e-8):
    (pj, qj, mj), (pt, qt, mt) = jax_out, port_out
    n = int(mj["iters_run"])
    assert int(mt["iters_run"]) == n
    for key in ("minf", "residual", "gamma", "grad_norm", "gamma_prb"):
        np.testing.assert_allclose(mt[key], mj[key], rtol=tol, atol=0,
                                   err_msg=key)
    assert np.abs(pt - pj).max() <= tol * np.abs(pj).max()
    assert np.abs(qt - qj).max() <= tol * np.abs(qj).max()


@pytest.mark.parametrize("kw", [
    dict(),                       # 'auto' line search -> 'interp' here
    dict(model="poisson"),
    dict(direction="lbfgs", linesearch="backtracking"),
    dict(nchunks=4),
], ids=["defaults", "poisson", "lbfgs", "nchunks4"])
def test_run_pallas_matches_jax(problem, kw):
    """Object-only runs: the classic materialized body, as on 'xla'."""
    kernel_runs = kernels.gather_probe_mul_reference.launches
    jax_out, port_out = run_both(problem, dict(piter=ITERS, **kw))
    assert_same_trajectory(jax_out, port_out)
    # Every operator went through the tier's kernels (their plain versions
    # here): at least two forward passes an iteration.
    assert (kernels.gather_probe_mul_reference.launches - kernel_runs
            >= 2 * ITERS * kw.get("nchunks", 1))


@pytest.mark.parametrize("kw", [dict(), dict(model="poisson", nchunks=2)],
                         ids=["gaussian", "poisson-nchunks2"])
def test_joint_run_pallas_matches_jax(problem, kw):
    """Joint recovery, 16 iterations (joint trajectories are chaotic in the
    object/probe scale: rounding differences grow ~1.3x an iteration)."""
    before = kernels.adj_probe_reduce_reference.launches
    jax_out, port_out = run_both(problem, dict(piter=ITERS, recover_prb=True,
                                               **kw), joint=True)
    assert_same_trajectory(jax_out, port_out)
    assert (kernels.adj_probe_reduce_reference.launches - before
            == ITERS * kw.get("nchunks", 1))
    assert np.abs(port_out[1] - problem[4]).max() > 0  # the probe moved


@pytest.mark.parametrize("nchunks", [1, 4])
def test_split_operator_pallas_matches_jax(problem, nchunks):
    """CG on a correction from zero with a frozen base farplane; a
    frameless split base raises for 'pallas' as for 'xla'."""
    data, psi0, scan, prb, _ = problem
    psi_b, _, _ = jcg.run(*map(jnp.asarray, (data, psi0, scan, prb)), GEOM,
                          piter=8, kernel="xla")
    f_base = np.asarray(jdiff.fwd_raw(psi_b, jnp.asarray(scan),
                                      jnp.asarray(prb), GEOM.ndet, "xla"))
    zero = np.zeros(GEOM.psi_shape, np.complex128)
    out = run_both(problem, dict(piter=ITERS, nchunks=nchunks),
                   f_base=f_base, psi0=zero)
    assert_same_trajectory(*out)
    with pytest.raises(ValueError, match="frameless split-operator"):
        tcg.run(*map(cpu, (data, zero, scan, prb)), geometry_from(GEOM),
                piter=2, kernel="pallas", memory="frameless",
                f_base=cpu(f_base))


def test_run_pallas_complex64_against_jax_pallas(problem):
    """One short complex64 run against the JAX package's own 'pallas' tier
    (interpret-mode Pallas kernels): fp32 rounding over eight iterations,
    2e-4 relative on the objective."""
    data, psi0, scan, prb, _ = problem
    args = (data.astype(np.float32), psi0.astype(np.complex64),
            scan.astype(np.float32), prb.astype(np.complex64))
    _, _, mj = jcg.run(*map(jnp.asarray, args), GEOM, piter=8,
                       kernel="pallas")
    pt, _, mt = tcg.run(*map(cpu, args), geometry_from(GEOM), piter=8,
                        kernel="pallas")
    assert pt.dtype == torch.complex64
    assert int(mt["iters_run"]) == int(mj["iters_run"]) == 8
    np.testing.assert_allclose(to_numpy(mt["minf"]), np.asarray(mj["minf"]),
                               rtol=2e-4)


def test_options_normalization_on_the_hybrid_tier():
    """'auto' line search resolves to 'interp' off the deep fused tiers;
    the hybrid tier has no frameless or merged body."""
    g = geometry_from(GEOM)
    eng = tcg._Engine(g, tcg.CGOptions(kernel="pallas"), "cuda")
    assert (eng.kernel, eng.ls, eng.fused, eng.frameless, eng.merged) == (
        "pallas", "interp", False, False, False)
    je = jcg._Engine(GEOM, jcg.CGOptions(kernel="pallas"))
    assert (je.ls, je.frameless, je.merged) == (eng.ls, eng.frameless,
                                                eng.merged)
    eng = tcg._Engine(g, tcg.CGOptions(kernel="pallas",
                                       fused_linesearch=True), "cuda")
    assert not eng.fused_linesearch  # the one-pass search is the fused tiers'


# -- reconstruct on the hybrid tier -----------------------------------------

DEEP = tikejax.Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)


def test_reconstruct_pallas_stages_match_jax():
    """reconstruct(fast_kernel='pallas', base_kernel='pallas') against the
    JAX package on 'xla' in float64: the same stages (with the tier's name),
    the same iteration counts and residuals to 1e-8."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(3), DEEP,
                                      dtype=jnp.complex128)
    prob = tuple(np.asarray(x) for x in (
        data, np.ones(DEEP.psi_shape, np.complex128), scan, prb))
    kw = dict(target_residual=3e-4, segment=12, max_segments=12)
    _, _, sj = jreconstruct(*map(jnp.asarray, prob), DEEP,
                            tiers=(("xla", 5e-3, 96),), **kw)
    before = kernels.gather_probe_mul_reference.launches
    _, _, st = reconstruct(*map(cpu, prob), geometry_from(DEEP),
                           fast_kernel="pallas", base_kernel="pallas",
                           tiers=(("pallas", 5e-3, 96),), **kw)
    assert kernels.gather_probe_mul_reference.launches > before
    assert [n for n, _ in st] == [n.replace("xla", "pallas") for n, _ in sj]
    assert st[0][0] == "pallas" and st[-1][0] == "split:pallas"
    assert len(st) >= 3
    for (name, mj), (_, mt) in zip(sj, st):
        assert int(mt["iters_run"]) == int(mj["iters_run"]), name
        np.testing.assert_allclose(to_numpy(mt["residual"]),
                                   np.asarray(mj["residual"]), rtol=1e-8,
                                   atol=0, err_msg=name)
