"""The port's position (P1) and angle (P2) sharding on gloo ranks, against
``tikejax.parallel.run_sharded`` on the conftest's 8-device virtual CPU mesh
and against the port's one-process run.

Every rank is a process of its own: a module-scoped ``RankPool`` of 2 and
one of 4 ranks start once, and each case hands every rank the same job
(``tikejax_torch.parallel._jobs``: the ranks import the port, never jax,
which the cases check). Every rank gets the global problem and keeps its
slice. In float64 on the oracle path the sharded run equals both references
to 1e-8 (the sums over positions run in another order): iteration counts,
the line search's accept/reject pattern, the per-iteration metrics and the
final object. The ranks are held to one another more tightly: the same
object and metrics bit for bit, and the same number of collectives (the
lock-step contract: every branch reads an all-reduced value). A case whose
ranks outlast CASE_TIMEOUT fails, and the pool restarts for the next.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax import compat as jcompat
from tikejax.models import make_problem
from tikejax.parallel import make_mesh as jmake_mesh
from tikejax.parallel import run_sharded as jrun_sharded
from tikejax.solvers import cg as jcg
from tikejax.solvers import reconstruct as jreconstruct
from tikejax_torch import compat as tcompat
from tikejax_torch.parallel import RankPool, _dryrun, _jobs
from tikejax_torch.solvers import cg as tcg
from tikejax_torch.solvers import reconstruct as treconstruct
from tikejax_torch.utils import geometry_from, to_numpy, to_torch

# Seconds a case's ranks may take (a few at these sizes): a rank that hangs
# fails its case instead of stalling the run.
CASE_TIMEOUT = 90
TOL = 1e-8

GEOM = tikejax.Geometry(nz=48, n=48, nscan=24, ndet=24, nprb=16)
GEOM_UNEVEN = tikejax.Geometry(nz=48, n=48, nscan=23, ndet=24, nprb=16)
GEOM_MODES = tikejax.Geometry(nz=48, n=48, nscan=24, ndet=24, nprb=16,
                              nmodes=2)
GEOM_THETA = tikejax.Geometry(nz=48, n=48, nscan=24, ndet=24, nprb=16,
                              ntheta=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores (the ranks run at one thread too);
    restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        if n not in made:
            made[n] = RankPool(n, timeout=CASE_TIMEOUT,
                               collective_timeout=CASE_TIMEOUT / 2)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


def problem(g, key=0, **kw):
    """The JAX package's problem in complex128, as numpy arrays."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(key), g,
                                      dtype=jnp.complex128, **kw)
    return {"data": np.asarray(data),
            "psi0": np.ones(g.psi_shape, np.complex128),
            "scan": np.asarray(scan), "prb": np.asarray(prb)}


def cpu(x):
    return to_torch(x, device="cpu")


def world(mesh_shape):
    return (mesh_shape[0] * mesh_shape[1] if isinstance(mesh_shape, tuple)
            else mesh_shape)


def port_sharded(pools, what, mesh_shape, g, arrays, kw):
    """Every rank's result of the job; checks the ranks agree bit for bit,
    made the same collectives and loaded no jax."""
    results = pools(world(mesh_shape)).run(_jobs.sharded, what, mesh_shape,
                                           geometry_from(g), arrays, kw)
    first = results[0]
    for r in results:
        assert r["jax"] == [], r["jax"]
        assert r["collectives"] == first["collectives"] > 0
        assert_identical(r["out"], first["out"])
    return first


def assert_identical(a, b):
    """The same values bit for bit, but a carried ``cg_state``, which a
    theta mesh keeps per angle (each rank its own)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            if k != "cg_state":
                assert_identical(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_identical(x, y)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def jax_mesh(mesh_shape):
    return jmake_mesh(mesh_shape)


def jax_sharded(g, arrays, mesh_shape, **kw):
    psi, prb, m = jrun_sharded(*(jnp.asarray(arrays[k]) for k in (
        "data", "psi0", "scan", "prb")), g, jax_mesh(mesh_shape), **kw)
    return np.asarray(psi), np.asarray(prb), {
        k: np.asarray(v) for k, v in m.items() if k != "cg_state"}


def port_single(g, arrays, **kw):
    psi, prb, m = tcg.run(*(cpu(arrays[k]) for k in (
        "data", "psi0", "scan", "prb")), geometry_from(g), **kw)
    return to_numpy(psi), to_numpy(prb), m


def numpy_metrics(m):
    return {k: (to_numpy(v) if torch.is_tensor(v) else v)
            for k, v in m.items() if k != "cg_state"}


def assert_same_run(got, ref, tol=TOL):
    """(psi, prb, metrics) against (psi, prb, metrics): the iterations,
    the accept/reject pattern, the metrics and the final object and
    probe."""
    psi, prb, m = got[0], got[1], numpy_metrics(got[2])
    psi_r, prb_r, m_r = ref[0], ref[1], numpy_metrics(ref[2])
    n = int(m_r["iters_run"])
    assert int(m["iters_run"]) == n
    np.testing.assert_array_equal(m["gamma"][:n] == 0, m_r["gamma"][:n] == 0)
    for key in ("minf", "residual", "gamma", "grad_norm", "gamma_prb"):
        np.testing.assert_allclose(m[key], m_r[key], rtol=tol, atol=0,
                                   err_msg=key)
    assert np.abs(to_numpy(psi) - psi_r).max() <= tol * np.abs(psi_r).max()
    assert np.abs(to_numpy(prb) - prb_r).max() <= tol * np.abs(prb_r).max()


def check_against_both(pools, mesh_shape, g, arrays, kw, jax_kw=None,
                       tol=TOL):
    """The sharded port against the sharded JAX package and the port's one
    process; returns rank 0's result."""
    got = port_sharded(pools, "run_sharded", mesh_shape, g, arrays, kw)
    psi, prb, m = got["out"]
    assert psi.shape == g.psi_shape and prb.shape == g.prb_shape
    assert_same_run((psi, prb, m),
                    jax_sharded(g, arrays, mesh_shape, **(jax_kw or kw)),
                    tol)
    assert_same_run((psi, prb, m), port_single(g, arrays, **kw), tol)
    return got


@pytest.mark.parametrize("n", [2, 4])
def test_scan_mesh_matches_jax_and_one_process(pools, n):
    check_against_both(pools, n, GEOM, problem(GEOM),
                       dict(piter=10, kernel="xla"))


def test_uneven_nscan_is_padded(pools):
    """23 positions on 4 ranks: the tail shard holds sentinel dummies."""
    check_against_both(pools, 4, GEOM_UNEVEN, problem(GEOM_UNEVEN, 1),
                       dict(piter=10, kernel="xla"))


def test_joint_two_modes_streamed(pools):
    """Probe recovery with two modes and two chunks of positions a rank,
    Poisson."""
    check_against_both(pools, 2, GEOM_MODES, problem(GEOM_MODES, 2),
                       dict(piter=6, kernel="xla", recover_prb=True,
                            nchunks=2, model="poisson",
                            linesearch="interp"))


def test_fused_tier_through_the_plain_versions(pools):
    """The merged body (every candidate one grad_fused pass, here its plain
    version) against JAX's 'xla' classic backtracking and the port's one
    process on the same tier."""
    kw = dict(piter=10, kernel="fused_mx")
    got = port_sharded(pools, "run_sharded", 2, GEOM, problem(GEOM), kw)
    run = got["out"]
    assert run[2]["evaluations"] >= 11
    assert_same_run(run, jax_sharded(GEOM, problem(GEOM), 2, piter=10,
                                     kernel="xla",
                                     linesearch="backtracking"), 1e-7)
    assert_same_run(run, port_single(GEOM, problem(GEOM), **kw))


@pytest.mark.parametrize("ring", [False, True], ids=["dy-slots", "ring"])
def test_lbfgs_continues_across_segments(pools, ring):
    """Two L-BFGS segments, the second from the first's carried state,
    with and without the (S, Y) ring."""
    arrays = problem(GEOM)
    kw = dict(piter=5, kernel="xla", direction="lbfgs", carry_state=True,
              carry_lbfgs=ring)
    got = port_sharded(pools, "two_segments", 2, GEOM, arrays, kw)["out"]
    mesh = jax_mesh(2)
    j = [jnp.asarray(arrays[k]) for k in ("data", "psi0", "scan", "prb")]
    psi_j, _, m_j = jrun_sharded(*j, GEOM, mesh, **kw)
    psi_j, prb_j, m_j = jrun_sharded(j[0], psi_j, j[2], j[3], GEOM, mesh,
                                     cg_init=m_j["cg_state"], **kw)
    assert_same_run(got, (np.asarray(psi_j), np.asarray(prb_j), {
        k: np.asarray(v) for k, v in m_j.items() if k != "cg_state"}))
    assert len(got[2]["cg_state"]) == (8 if ring else 4)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 1)], ids=str)
def test_theta_mesh_matches_jax_and_one_process(pools, mesh_shape):
    """Two angles on a ('theta', 'scan') mesh: psi and prb per angle
    with no collective, the scalars and inner products over both; psi and
    prb come back global on every rank."""
    got = check_against_both(pools, mesh_shape, GEOM_THETA,
                             problem(GEOM_THETA, 3),
                             dict(piter=8, kernel="xla",
                                  direction="lbfgs"))
    assert got["out"][0].shape == GEOM_THETA.psi_shape


def test_theta_mesh_joint_probe(pools):
    check_against_both(pools, (2, 1), GEOM_THETA, problem(GEOM_THETA, 4),
                       dict(piter=6, kernel="xla", recover_prb=True,
                            linesearch="interp"))


def test_pad_scan_problem_and_fwd_sharded(pools):
    """Each rank's slice of the padded problem (sentinel rows -1 at the
    tail) and its farplane slice, against the global oracle forward."""
    arrays = problem(GEOM_UNEVEN, 5)
    results = pools(2).run(_jobs.sharded, "fwd_sharded", 2,
                           geometry_from(GEOM_UNEVEN), arrays,
                           dict(kernel="xla"))
    from tikejax_torch.ops import diffraction
    from tikejax_torch.parallel import pad_scan_problem

    data, scan, g = pad_scan_problem(cpu(arrays["data"]), cpu(arrays["scan"]),
                                     geometry_from(GEOM_UNEVEN), 2)
    assert g.nscan == 24 and scan.shape == (1, 24, 2)
    assert float(scan[0, -1, 0]) == -1 and float(data[0, -1].abs().max()) == 0
    full = diffraction.fwd_raw(cpu(arrays["psi0"]), scan, cpu(arrays["prb"]),
                               g.ndet, "xla")
    for r in results:
        scan_l, far_l = r["out"]
        part = slice(12 * r["rank"], 12 * (r["rank"] + 1))
        assert torch.equal(scan_l, scan[:, part])
        assert torch.equal(far_l, full[:, part])
    assert float(results[1]["out"][1][0, -1].abs().max()) == 0.0


@pytest.mark.parametrize("method", ["split", "tiers"])
def test_reconstruct_on_a_mesh(pools, method):
    """A short split run (stage 1, then three refinement segments with
    Anderson mixing), and a two-tier chain, on 2 ranks, against the port's
    one process and the JAX package's reconstruct(mesh=)."""
    arrays = problem(GEOM)
    kw = dict(target_residual=1e-4, segment=8, max_segments=3,
              tiers=(("xla", 3e-2, 16),))
    if method == "tiers":
        kw = dict(target_residual=1e-4, method="tiers",
                  tiers=(("xla", 3e-2, 16), ("xla", 0.0, 12)))
    psi, prb, stages = port_sharded(pools, "reconstruct", 2, GEOM, arrays,
                                    kw)["out"]
    psi_1, prb_1, stages_1 = treconstruct(
        *(cpu(arrays[k]) for k in ("data", "psi0", "scan", "prb")),
        geometry_from(GEOM), **kw)
    psi_j, _, stages_j = jreconstruct(
        *(jnp.asarray(arrays[k]) for k in ("data", "psi0", "scan", "prb")),
        GEOM, mesh=jax_mesh(2), **kw)
    names = [name for name, _ in stages]
    assert names == [name for name, _ in stages_1] == [
        name for name, _ in stages_j]
    assert names == (["xla"] + ["split:xla"] * 3 if method == "split"
                     else ["xla", "xla"])
    for (_, m), (_, m1), (_, mj) in zip(stages, stages_1, stages_j):
        n = int(m1["iters_run"])
        assert int(m["iters_run"]) == n == int(mj["iters_run"])
        for ref in (to_numpy(m1["residual"]), np.asarray(mj["residual"])):
            np.testing.assert_allclose(to_numpy(m["residual"])[:n],
                                       ref[:n], rtol=TOL, atol=0)
    for ref in (to_numpy(psi_1), np.asarray(psi_j)):
        assert np.abs(to_numpy(psi) - ref).max() <= TOL * np.abs(ref).max()


def test_reconstruct_on_a_mesh_resumes_a_checkpoint(pools, tmp_path,
                                                    monkeypatch):
    """A one-process split run killed after stage 1 and two refinement
    segments leaves a checkpoint; the same call on a (2, 2) mesh resumes
    from it on every rank (the carried state sliced per angle), writes its
    own checkpoints from rank 0 (the state gathered) and reproduces the
    remaining stages of the uninterrupted run, then removes the file."""
    arrays = problem(GEOM_THETA, 6)
    args = [cpu(arrays[k]) for k in ("data", "psi0", "scan", "prb")]
    path = str(tmp_path / "mesh.ckpt.npz")
    kw = dict(target_residual=1e-5, segment=8, max_segments=5,
              tiers=(("xla", 3e-2, 16),), checkpoint_every=1)
    g = geometry_from(GEOM_THETA)
    _, _, ref = treconstruct(*args, g, **kw)
    real_run, calls = tcg.run, {"n": 0}

    def crashing_run(*a, **k):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("simulated crash")
        return real_run(*a, **k)

    monkeypatch.setattr(tcg, "run", crashing_run)
    with pytest.raises(RuntimeError, match="simulated"):
        treconstruct(*args, g, checkpoint_path=path, **kw)
    monkeypatch.setattr(tcg, "run", real_run)
    assert os.path.exists(path)
    psi, _, stages = port_sharded(pools, "reconstruct", (2, 2), GEOM_THETA,
                                  arrays, dict(kw, checkpoint_path=path))[
                                      "out"]
    assert len(stages) == len(ref) - 3 > 0
    for (name, m), (name_r, m_r) in zip(stages, ref[3:]):
        n = int(m_r["iters_run"])
        assert name == name_r and int(m["iters_run"]) == n
        np.testing.assert_allclose(to_numpy(m["residual"])[:n],
                                   to_numpy(m_r["residual"])[:n], rtol=TOL,
                                   atol=0)
    assert not os.path.exists(path)


def test_facade_on_a_mesh(pools):
    """CGPtychoSolver(...).run(mesh=): numpy in, numpy out. Both facades
    take complex64, so the tolerances are fp32's: against the facade's own
    one-process run 1e-5, against the JAX facade's mesh run those of
    ``tests/test_torch_compat.py`` (the objective to 2e-4, the object to
    1e-3 of scale)."""
    arrays = problem(GEOM)
    dims = dict(ntheta=1, nz=GEOM.nz, n=GEOM.n, nscan=GEOM.nscan,
                ndet=GEOM.ndet, nprb=GEOM.nprb)
    out = port_sharded(pools, "facade", 2, GEOM, arrays,
                       dict(piter=8, kernel="xla"))["out"]
    args = [arrays[k] for k in ("data", "psi0", "scan", "prb")]
    one = tcompat.CGPtychoSolver(**dims, kernel="xla", device="cpu").run(
        *args, piter=8)
    ref = jcompat.CGPtychoSolver(**dims, kernel="xla").run(
        *args, piter=8, mesh=jax_mesh(2))
    assert isinstance(out["psi"], np.ndarray)
    assert out["psi"].dtype == np.complex64
    assert int(out["iters_run"]) == int(one["iters_run"]) == 8
    np.testing.assert_array_equal(out["gamma"] == 0, ref["gamma"] == 0)
    for r, minf_tol, psi_tol in ((one, 1e-5, 1e-5), (ref, 2e-4, 1e-3)):
        np.testing.assert_allclose(out["minf"], r["minf"], rtol=minf_tol)
        assert np.abs(out["psi"] - r["psi"]).max() <= psi_tol * np.abs(
            r["psi"]).max()


def test_validation_errors(pools):
    """The JAX package's checks, with its messages, on every rank: ntheta
    not divisible by the theta dimension, a base farplane on an unpadded
    scan axis, a mesh of the wrong size, an uneven shard; plus what only
    the port has: a mesh that is not a DeviceMesh, and the object-tiling
    fields, which only ``parallel.run_tiled`` takes."""
    arrays = problem(GEOM_UNEVEN)
    arrays["f_base"] = np.zeros(GEOM_UNEVEN.farplane_shape, np.complex128)
    cases = [("run_sharded", dict(kernel="xla", f_base="f_base")),
             ("make_mesh", dict(shape=3)),
             ("shard_problem", {}),
             ("run_sharded", dict(kernel="xla", mesh=None)),
             ("run_sharded", dict(kernel="xla", obj_axis_name="obj")),
             ("reconstruct", dict(obj_halo=2))]
    results = pools(2).run(_jobs.errors, 2, geometry_from(GEOM_UNEVEN),
                           arrays, cases)
    assert all(r == results[0] for r in results)
    found = results[0]
    assert found[0] == ("ValueError", found[0][1])
    assert "f_base must match a pre-padded scan axis" in found[0][1]
    assert found[1][0] == "ValueError" and "needs 3 devices, have 2" in (
        found[1][1])
    assert found[2][0] == "ValueError" and "pad_scan_problem" in found[2][1]
    assert found[3][0] == "ValueError" and "DeviceMesh" in found[3][1]
    for kind, msg in found[4:]:
        assert kind == "ValueError" and "run_tiled" in msg
    with pytest.raises(ValueError, match="f_base must match a pre-padded"):
        jrun_sharded(*(jnp.asarray(arrays[k]) for k in (
            "data", "psi0", "scan", "prb")), GEOM_UNEVEN, jax_mesh(2),
            f_base=jnp.asarray(arrays["f_base"]), kernel="xla")
    # ntheta = 1 on a theta dimension of 2.
    found = pools(4).run(_jobs.errors, (2, 2), geometry_from(GEOM),
                         problem(GEOM), [("run_sharded", {})])[0]
    assert found[0][0] == "ValueError" and (
        "ntheta (1) must be divisible by the theta mesh axis size (2)"
        in found[0][1])
    with pytest.raises(ValueError, match=r"ntheta \(1\) must be divisible"):
        jrun_sharded(*(jnp.asarray(v) for v in problem(GEOM).values()),
                     GEOM, jax_mesh((2, 2)))


def test_make_mesh_follows_a_new_process_group(tmp_path):
    """A mesh is made once per process group: the same mesh again while
    the group lives, a new one once the group is destroyed and made anew,
    and the new mesh's group reduces."""
    import torch.distributed as dist
    from tikejax_torch.parallel import make_mesh

    assert not dist.is_initialized()
    meshes = []
    for i in range(2):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/{i}",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(1, device_type="cpu")
            assert make_mesh(1, device_type="cpu") is mesh
            x = torch.ones(3)
            dist.all_reduce(x, group=mesh.get_group())
            assert x.tolist() == [1.0, 1.0, 1.0]
            meshes.append(mesh)
        finally:
            dist.destroy_process_group()
    assert meshes[1] is not meshes[0]


def test_lock_step_with_different_local_data(pools):
    """Four ranks, each with positions of its own (and so objectives and
    gradients of its own), through the 'interp' search, whose extra
    directional-derivative reads depend on the values: every rank makes
    the same collectives and takes the same steps, bit for bit."""
    arrays = problem(GEOM, 7)
    results = pools(4).run(_jobs.sharded, "run_sharded", 4,
                           geometry_from(GEOM), arrays,
                           dict(piter=12, kernel="xla", linesearch="interp",
                                step0=16.0))
    steps = [to_numpy(r["out"][2]["gamma"]) for r in results]
    counts = [r["collectives"] for r in results]
    syncs = [r["out"][2]["host_syncs"] for r in results]
    assert len(set(counts)) == 1 and counts[0] > 12
    assert len(set(syncs)) == 1
    assert all(np.array_equal(s, steps[0]) for s in steps)
    assert not np.all(np.log2(steps[0][steps[0] > 0]) % 1 == 0)  # interp


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_matches_one_process(pools, n):
    """The dry run's sharded step ((2, 1) and (2, 2) meshes, two angles,
    two modes, one joint iteration on the 'fused' tier's plain versions)
    against the one-process step, to its stated tolerance."""
    errs = _dryrun.run_dryrun(n, pool=pools(n))
    assert max(errs["psi"], errs["prb"], errs["minf"]) <= _dryrun.DRYRUN_TOL
    assert errs["collectives"] > 0


def test_dryrun_multichip_in_a_subprocess():
    from tikejax_torch.graft_entry import dryrun_multichip

    assert dryrun_multichip(3, timeout=CASE_TIMEOUT).startswith(
        "dryrun_multichip(3): OK")


def test_graft_entry_step_matches_the_reference_entry():
    """``graft_entry.entry()``'s step (on the CPU: the oracle operators)
    against ``__graft_entry__.entry()``'s step on the same arrays
    (complex64 in both: the objective, a float32 sum over a million
    pixels in two orders, to 1e-4; the gradient to 1e-5 of scale)."""
    import __graft_entry__
    from tikejax_torch.graft_entry import ENTRY_GEOMETRY, entry

    step, args = entry(device="cpu")
    assert args[0].shape == ENTRY_GEOMETRY.psi_shape == (1, 256, 256)
    assert args[1].shape == (1, 256, 2) and args[3].shape == (1, 256, 64, 64)
    # At the true object the objective is rounding noise: step from the
    # CG start, psi = 1, instead.
    args = (torch.ones_like(args[0]),) + args[1:]
    minf, grad = step(*args)
    assert float(minf) > 1.0
    jstep, _ = __graft_entry__.entry()
    jminf, jgrad = jstep(*(jnp.asarray(to_numpy(a)) for a in args))
    assert abs(float(minf) - float(jminf)) <= 1e-4 * abs(float(jminf))
    jgrad = np.asarray(jgrad)
    assert np.abs(to_numpy(grad) - jgrad).max() <= 1e-5 * np.abs(
        jgrad).max()


def test_a_hung_or_failing_rank_fails_its_job_and_the_pool_restarts(pools):
    """A job that outlasts its time limit (one rank late into a collective)
    fails with TimeoutError, a rank that raises fails the job with its
    traceback; either way the pool is stopped and the next job starts it
    afresh."""
    pool = pools(2)
    assert pool.run(_jobs.stall, 0.0) == [2.0, 2.0]
    starts = pool.starts
    with pytest.raises(TimeoutError, match="did not answer in time"):
        pool.run(_jobs.stall, 30.0, timeout=2.0)
    assert pool.run(_jobs.stall, 0.0) == [2.0, 2.0]
    with pytest.raises(RuntimeError, match=r"rank [01] failed"):
        pool.run(_jobs.errors, 2, geometry_from(GEOM), problem(GEOM),
                 [("no such entry", {})])
    assert pool.run(_jobs.stall, 0.0) == [2.0, 2.0]
    assert pool.starts == starts + 2
