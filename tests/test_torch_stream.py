"""Position streaming (``nchunks > 1``) in the port against the JAX package.

The gradient pass sums the chunks' objectives and adjoints in order, and
the line search keeps the quadratic statistics of every chunk, as the JAX
package's ``lax.scan`` does; the split-operator base is streamed through the
chunks with the data. Both packages solve the same problem (the JAX
package's ``make_problem`` in complex128, handed over as numpy arrays), so
the streamed trajectories agree to 1e-8, with each other and with the
unstreamed ones (only the order of the chunk sums differs). On the fused
tiers the chunks run the ``fwd``, ``adj`` and ``adj_probe`` operators (their
plain versions on the CPU).
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
from tikejax.solvers import cg as jcg
from tikejax.solvers import reconstruct as jreconstruct
from tikejax_torch.ops import fused
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
    return to_torch(x, device="cpu")


GEOM = tikejax.Geometry(nz=64, n=64, nscan=16, ndet=32, nprb=24)
ITERS = 12


@pytest.fixture(scope="module")
def problem():
    _, scan, prb, data = make_problem(jax.random.PRNGKey(0), GEOM,
                                      dtype=jnp.complex128)
    prb = np.asarray(prb)
    rng = np.random.default_rng(7)
    prb0 = prb + 0.03 * np.abs(prb).max() * (
        rng.standard_normal(prb.shape) + 1j * rng.standard_normal(prb.shape))
    return tuple(np.asarray(x) for x in (
        data, np.ones(GEOM.psi_shape, np.complex128), scan, prb0))


def jax_run(problem, f_base=None, **kw):
    pj, prj, mj = jcg.run(*map(jnp.asarray, problem), GEOM,
                          f_base=None if f_base is None
                          else jnp.asarray(f_base), **kw)
    return np.asarray(pj), np.asarray(prj), {
        k: np.asarray(v) for k, v in mj.items()}


def port_run(problem, f_base=None, **kw):
    pt, prt, mt = tcg.run(*map(cpu, problem), geometry_from(GEOM),
                          f_base=None if f_base is None else cpu(f_base),
                          **kw)
    return to_numpy(pt), to_numpy(prt), {
        k: (to_numpy(v) if torch.is_tensor(v) else v) for k, v in mt.items()}


def assert_same(a, b, tol=1e-8):
    (pa, pra, ma), (pb, prb, mb) = a, b
    n = int(ma["iters_run"])
    assert int(mb["iters_run"]) == n
    for key in ("minf", "residual", "gamma", "gamma_prb", "grad_norm"):
        np.testing.assert_allclose(mb[key], ma[key], rtol=tol, atol=0,
                                   err_msg=key)
    assert np.abs(pb - pa).max() <= tol * np.abs(pa).max()
    assert np.abs(prb - pra).max() <= tol * np.abs(pra).max()


@pytest.mark.parametrize("nchunks", [2, 4])
@pytest.mark.parametrize("kw", [
    dict(), dict(recover_prb=True), dict(recover_prb=True, model="poisson")],
    ids=["object", "joint", "joint-poisson"])
def test_streamed_run_matches_jax_and_the_unstreamed_run(problem, kw,
                                                         nchunks):
    kw = dict(piter=ITERS, kernel="xla", **kw)
    ref = jax_run(problem, **kw)
    assert_same(ref, port_run(problem, nchunks=nchunks, **kw))
    assert_same(ref, jax_run(problem, nchunks=nchunks, **kw))
    assert_same(port_run(problem, **kw),
                port_run(problem, nchunks=nchunks, **kw))


def test_streamed_fused_tier_runs_the_operator_kernels(problem):
    """On a fused tier each chunk goes through fwd, adj and adj_probe:
    per joint iteration, the object step's gradient (fwd + adj per chunk)
    and statistics (two fwd per chunk), then the probe step's (fwd +
    adj_probe, two fwd); never grad_fused or minf_fused. The trajectory is
    the oracle's."""
    k = 4
    counters = [fused.fwd_reference, fused.adj_reference,
                fused.adj_probe_reference, fused.grad_fused_reference,
                fused.grad_prb_fused_reference, fused.minf_fused_reference]
    before = [f.launches for f in counters]
    out = port_run(problem, piter=ITERS, kernel="fused_mx", nchunks=k,
                   recover_prb=True, linesearch="interp")
    counts = [f.launches - b for f, b in zip(counters, before)]
    assert counts == [6 * k * ITERS, k * ITERS, k * ITERS, 0, 0, 0]
    assert_same(jax_run(problem, piter=ITERS, kernel="xla", nchunks=k,
                        recover_prb=True), out)


def test_streamed_chunks_reach_adj_whole_and_contiguous(problem,
                                                         monkeypatch):
    """Each chunk's residual reaches ``fused.adj`` as a contiguous tensor
    of its own (storage offset 0, as the allocator aligns it): the 'fft'
    kernel's 16-byte loads take it as it is, and the wrapper's
    ``.contiguous()`` copies nothing."""
    seen = []
    adj = fused.adj

    def spy(farplane, *args, **kw):
        seen.append((farplane.is_contiguous(), farplane.storage_offset(),
                     farplane.untyped_storage().nbytes()
                     == farplane.numel() * farplane.element_size()))
        return adj(farplane, *args, **kw)

    monkeypatch.setattr(fused, "adj", spy)
    port_run(problem, piter=2, kernel="fused", nchunks=4, recover_prb=True)
    assert seen and all(s == (True, 0, True) for s in seen), seen


@pytest.fixture(scope="module")
def f_base(problem):
    """The farplane of an 8-iteration solve: the split-operator base."""
    psi_b, _, _ = jax_run(problem, piter=8, kernel="xla")
    return np.asarray(jdiff.fwd_raw(psi_b, jnp.asarray(problem[2]),
                                    jnp.asarray(problem[3]), GEOM.ndet,
                                    "xla"))


@pytest.mark.parametrize("port_kw", [
    dict(kernel="xla", nchunks=4), dict(kernel="fused_hp", nchunks=2)],
    ids=["xla-4", "fused_hp-2"])
def test_split_operator_streams_the_base(problem, f_base, port_kw):
    """CG on a correction from zero with a frozen base streamed through the
    chunks (the split refinement's memory regime), against JAX's oracle
    path with the same base and chunks."""
    zero = np.zeros(GEOM.psi_shape, np.complex128)
    prob = (problem[0], zero) + problem[2:]
    kw = dict(piter=ITERS, linesearch="interp", direction="lbfgs")
    ref = jax_run(prob, f_base=f_base, kernel="xla",
                  nchunks=port_kw["nchunks"], **kw)
    assert_same(ref, port_run(prob, f_base=f_base, **port_kw, **kw))
    views = torch.view_as_real(cpu(f_base)).unbind(-1)
    pt, _, mt = tcg.run(*map(cpu, prob), geometry_from(GEOM), f_base=views,
                        **port_kw, **kw)
    np.testing.assert_allclose(to_numpy(mt["minf"]), ref[2]["minf"],
                               rtol=1e-8, atol=0)


def test_reconstruct_inherits_nchunks(problem):
    """reconstruct passes nchunks to its stages, as the JAX package's: the
    split refinement streams its base, stage for stage the same."""
    kw = dict(target_residual=1e-4, segment=8, max_segments=8,
              tiers=(("xla", 5e-3, 64),), direction="dy", nchunks=2)
    _, _, sj = jreconstruct(*map(jnp.asarray, problem), GEOM, **kw)
    _, _, st = reconstruct(*map(cpu, problem), geometry_from(GEOM), **kw)
    assert [n for n, _ in st] == [n for n, _ in sj]
    assert len(st) >= 3
    for (name, mj), (_, mt) in zip(sj, st):
        assert int(mt["iters_run"]) == int(mj["iters_run"]), name
        np.testing.assert_allclose(to_numpy(mt["residual"]),
                                   np.asarray(mj["residual"]), rtol=1e-8,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("nchunks", [0, 3, 32])
def test_nchunks_must_divide_nscan(problem, nchunks):
    with pytest.raises(ValueError, match="must divide"):
        tcg.run(*map(cpu, problem), geometry_from(GEOM), piter=2,
                kernel="xla", nchunks=nchunks)


# -- more than one angle and more than one mode -----------------------------

GEOM2 = tikejax.Geometry(nz=48, n=48, nscan=16, ndet=32, nprb=16, ntheta=2,
                         nmodes=2)


@pytest.mark.parametrize("kw, port_kw", [
    (dict(model="poisson", recover_prb=True), dict(kernel="xla")),
    (dict(recover_prb=True), dict(kernel="fused_mx", linesearch="interp")),
    (dict(), dict(kernel="xla")),
], ids=["joint-poisson", "joint-fused_mx", "object"])
def test_two_angles_two_modes_streamed_run_matches_jax(kw, port_kw):
    """ntheta = 2, nmodes = 2, nchunks = 4: the streamed bodies against the
    JAX package's streamed oracle body, 12 iterations in float64 to 1e-8
    (a joint trajectory's rounding differences grow ~1.3x an iteration)."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(2), GEOM2,
                                      dtype=jnp.complex128)
    prb = np.asarray(prb)
    rng = np.random.default_rng(9)
    prb0 = prb + 0.03 * np.abs(prb).max() * (
        rng.standard_normal(prb.shape) + 1j * rng.standard_normal(prb.shape))
    problem = tuple(np.asarray(x) for x in (
        data, np.ones(GEOM2.psi_shape, np.complex128), scan, prb0))
    kw = dict(piter=ITERS, nchunks=4, **kw)
    pj, prj, mj = jcg.run(*map(jnp.asarray, problem), GEOM2, kernel="xla",
                          **kw)
    pt, prt, mt = tcg.run(*map(cpu, problem), geometry_from(GEOM2),
                          **dict(kw, **port_kw))
    assert_same((np.asarray(pj), np.asarray(prj),
                 {k: np.asarray(v) for k, v in mj.items()}),
                (to_numpy(pt), to_numpy(prt),
                 {k: (to_numpy(v) if torch.is_tensor(v) else v)
                  for k, v in mt.items()}))
