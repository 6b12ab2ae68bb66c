"""The port's object tiling (P3) on gloo ranks, against
``tikejax.parallel.run_tiled`` on the conftest's 8-device virtual CPU mesh
and against the port's one-process run.

The cases of ``tests/test_tiling.py``, held in float64 to 1e-8 (the sums
over positions and slabs run in other orders): iteration counts, the line
search's accept/reject pattern, the per-iteration metrics and the final
object and probe. Every rank is a process of its own: a module-scoped
``RankPool`` of 2 and one of 4 ranks start once, and each case hands every
rank the same job (``tikejax_torch.parallel._jobs``); the ranks import the
port, never jax, which the cases check, and are held to one another bit for
bit with the same counts of collectives. The reference's meshes of 8
devices become meshes of 4 ranks here ((2, 2) for its (2, 4) and (4, 2)
('obj', 'scan') meshes, (2, 2, 1) for its (2, 2, 2) three-axis mesh); the
8-rank three-axis mesh runs in the dry run's subprocess. The JAX package's
partition casts the data and the scan to float32, so its tiled run takes
the data's square roots and sums in float32: the inputs here are chosen so
that those are exact (the scan float32 values, each measured amplitude a
multiple of 1/8 below 512, so that the data, their square roots and their
sum are float32 values), and every run computes the same float64 problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax  # noqa: E402
from tikejax.models import (make_object, make_probe, raster_scan,  # noqa: E402
                            simulate_intensities)
from tikejax.parallel import make_obj_mesh as jmake_obj_mesh  # noqa: E402
from tikejax.parallel import make_obj_scan_mesh as jmake_obj_scan_mesh  # noqa: E402,E501
from tikejax.parallel import run_tiled as jrun_tiled  # noqa: E402
from tikejax.parallel.tiling import partition_problem as jpartition  # noqa: E402,E501
from tikejax.parallel.tiling import stitch as jstitch  # noqa: E402
from tikejax_torch.parallel import RankPool, _dryrun, _jobs  # noqa: E402
from tikejax_torch.parallel import tiling  # noqa: E402
from tikejax_torch.solvers import cg as tcg  # noqa: E402
from tikejax_torch.utils import geometry_from, to_numpy  # noqa: E402

# Seconds a case's ranks may take (a few at these sizes).
CASE_TIMEOUT = 90
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the ranks; restored after this module."""
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


def float32_exact(x):
    return np.asarray(x).astype(np.float32).astype(np.float64)


def exact_in_float32(intensities):
    """Intensities whose amplitudes are multiples of 1/8 below 512 (12
    significant bits): the data, their square roots and their sums up to
    2**18 are exact in float32."""
    amp = np.round(np.sqrt(np.asarray(intensities, np.float64)) * 8) / 8
    assert amp.max() < 512
    data = amp * amp
    assert data.sum() < 2**18
    return data


def tiling_problem(n_slabs, nz=96, n=96, nprb=24, ndet=32, rows_per=2,
                   cols=8, ntheta=1):
    """The reference's scan grid with exactly rows_per * cols positions a
    slab, in complex128 (the data exact in float32), as numpy arrays."""
    g = tikejax.Geometry(nz=nz, n=n, nscan=n_slabs * rows_per * cols,
                         ndet=ndet, nprb=nprb, ntheta=ntheta)
    owned = nz // n_slabs
    ys = []
    for d in range(n_slabs):
        lo = d * owned
        hi = min(lo + owned - 1, nz - nprb)
        ys.extend(np.linspace(lo, hi, rows_per))
    xs = np.linspace(0, n - nprb, cols)
    yy, xx = np.meshgrid(np.asarray(ys), xs, indexing="ij")
    grid = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
    scan = np.broadcast_to(grid[None], (ntheta, g.nscan, 2))
    return g, arrays_for(g, scan)


def arrays_for(g, scan):
    psi_true = make_object(jax.random.PRNGKey(0), g.ntheta, g.nz, g.n,
                           jnp.complex128)
    prb = make_probe(g.ntheta, 1, g.nprb, jnp.complex128)
    scan = float32_exact(scan)
    data = exact_in_float32(simulate_intensities(
        psi_true, jnp.asarray(scan), prb, g.ndet))
    return {"data": data, "psi0": np.ones(g.psi_shape, np.complex128),
            "scan": scan, "prb": np.asarray(prb),
            "psi_true": np.asarray(psi_true)}


def inputs(arrays, prb_scale=1.0):
    return {"data": arrays["data"], "psi0": arrays["psi0"],
            "scan": arrays["scan"], "prb": arrays["prb"] * prb_scale}


def world(mesh_shape):
    return int(np.prod(mesh_shape))


def port_tiled(pools, mesh_shape, g, arrays, kw):
    """Rank 0's result of ``run_tiled``; checks the ranks agree bit for
    bit, made the same all-reduces (and halo exchanges) and loaded no
    jax."""
    results = pools(world(mesh_shape)).run(_jobs.tiled, mesh_shape,
                                           geometry_from(g), arrays, kw)
    first = results[0]
    for r in results:
        assert r["jax"] == [], r["jax"]
        assert r["collectives"] == first["collectives"]
        # A slab between two others takes part in two pair groups.
        assert r["halo"] in (first["halo"], 2 * first["halo"])
        for a, b in zip(r["out"][:2], first["out"][:2]):
            assert torch.equal(a, b)
        for k, v in r["out"][2].items():
            assert np.array_equal(np.asarray(v),
                                  np.asarray(first["out"][2][k]))
    return first


def jax_mesh(mesh_shape):
    if len(mesh_shape) == 1:
        return jmake_obj_mesh(mesh_shape[0])
    if len(mesh_shape) == 2:
        return jmake_obj_scan_mesh(*mesh_shape)
    from tikejax.parallel import make_full_mesh

    return make_full_mesh(*mesh_shape)


def jax_tiled(g, arrays, mesh_shape, **kw):
    psi, prb, m = jrun_tiled(*(jnp.asarray(arrays[k]) for k in (
        "data", "psi0", "scan", "prb")), g, jax_mesh(mesh_shape), **kw)
    return np.asarray(psi), np.asarray(prb), {
        k: np.asarray(v) for k, v in m.items() if k != "cg_state"}


def port_single(g, arrays, **kw):
    psi, prb, m = tcg.run(*(torch.from_numpy(np.array(arrays[k])) for k in (
        "data", "psi0", "scan", "prb")), geometry_from(g), **kw)
    return to_numpy(psi), to_numpy(prb), m


def numpy_metrics(m):
    return {k: (to_numpy(v) if torch.is_tensor(v) else np.asarray(v))
            for k, v in m.items() if k != "cg_state"}


def assert_same_run(got, ref, tol=TOL):
    """(psi, prb, metrics) against (psi, prb, metrics)."""
    psi, prb, m = (to_numpy(got[0]) if torch.is_tensor(got[0]) else got[0],
                   to_numpy(got[1]) if torch.is_tensor(got[1]) else got[1],
                   numpy_metrics(got[2]))
    psi_r, prb_r, m_r = ref[0], ref[1], numpy_metrics(ref[2])
    n = int(m_r["iters_run"])
    assert int(m["iters_run"]) == n
    np.testing.assert_array_equal(m["gamma"][:n] == 0, m_r["gamma"][:n] == 0)
    for key in ("minf", "residual", "gamma", "grad_norm", "gamma_prb"):
        np.testing.assert_allclose(m[key], m_r[key], rtol=tol, atol=0,
                                   err_msg=key)
    assert np.abs(psi - psi_r).max() <= tol * np.abs(psi_r).max()
    assert np.abs(prb - prb_r).max() <= tol * np.abs(prb_r).max()


def check_against_both(pools, mesh_shape, g, arrays, kw, jax_kw=None,
                       tol=TOL):
    """The tiled port against the tiled JAX package and the port's one
    process; returns rank 0's result."""
    got = port_tiled(pools, mesh_shape, g, arrays, kw)
    psi, prb, m = got["out"]
    assert psi.shape == g.psi_shape and prb.shape == g.prb_shape
    assert_same_run(got["out"], jax_tiled(g, arrays, mesh_shape,
                                          **(jax_kw or kw)), tol)
    assert_same_run(got["out"], port_single(g, arrays, **kw), tol)
    return got


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_tiled_matches_single(pools, n_slabs):
    g, arrays = tiling_problem(n_slabs)
    got = check_against_both(pools, (n_slabs,), g, inputs(arrays),
                             dict(piter=10, kernel="xla"))
    assert got["halo"] > 0 and got["collectives"] > 0


def test_tiled_joint_probe_and_fused(pools):
    """Joint recovery on the 'fused' tier (its plain versions here, the
    frameless classic body) against JAX's 'xla' classic body in float64
    (JAX's interpret-mode Pallas kernels return complex64) and the port's
    one process on the same tier."""
    g, arrays = tiling_problem(2)
    kw = dict(piter=8, recover_prb=True, kernel="fused")
    check_against_both(pools, (2,), g, inputs(arrays, 0.9), kw,
                       jax_kw=dict(kw, kernel="xla"))


def test_partition_validation():
    """The reference's ValueErrors, with its messages."""
    g, arrays = tiling_problem(2)
    a = inputs(arrays)
    for fn in (tiling.partition_problem, jpartition):
        with pytest.raises(ValueError, match="divide"):
            fn(a["psi0"], a["scan"], a["data"], g, 5)  # 96 % 5 != 0
        g2 = tikejax.Geometry(nz=96, n=96, nscan=g.nscan, ndet=32, nprb=24)
        with pytest.raises(ValueError, match="slab height"):
            fn(a["psi0"], a["scan"], a["data"], g2, 8)  # owned 12 < 23
        bad = a["scan"].copy()
        bad[0, 0, 0] = 90.0
        with pytest.raises(ValueError, match="out of bounds"):
            fn(a["psi0"], bad, a["data"], g, 2)


def test_partition_unequal_counts_padded():
    """Unequal owner counts are padded with sentinel dummies (row -1, zero
    data) to the largest: the reference's partition, value for value."""
    g, arrays = tiling_problem(2)
    a = inputs(arrays)
    bad = a["scan"].copy()
    bad[0, 0, 0] = 50.0
    got = tiling.partition_problem(a["psi0"], bad, a["data"], g, 2)
    ref = jpartition(a["psi0"], bad, a["data"], g, 2)
    slabs, scan_loc, data_p, owned = got
    assert scan_loc.shape[2] == g.nscan // 2 + 1
    assert int((scan_loc[..., 0] >= 0).sum()) == g.nscan
    dummy = scan_loc[..., 0] < 0
    assert bool((data_p[dummy] == 0).all())
    assert owned == ref[3]
    for x, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(to_numpy(x), np.asarray(r))


@pytest.mark.parametrize("kern", ["xla", "fused"])
def test_tiled_jittered_scan_matches_single(pools, kern):
    """A jittered raster scan (unequal owner counts, sentinel-padded) on
    each tier; 'fused' (the merged body through grad_fused's plain
    version) against JAX's 'xla' with the same line search."""
    g = tikejax.Geometry(nz=96, n=96, nscan=30, ndet=32, nprb=24)
    scan = np.asarray(raster_scan(jax.random.PRNGKey(3), g, jitter=3.0))
    owner = np.floor(scan[..., 0]).astype(int) // (g.nz // 2)
    assert (owner == 0).sum() != (owner == 1).sum()
    arrays = arrays_for(g, scan)
    kw = dict(piter=10, kernel=kern)
    jax_kw = dict(kw) if kern == "xla" else dict(piter=10, kernel="xla",
                                                  linesearch="interp")
    check_against_both(pools, (2,), g, inputs(arrays), kw, jax_kw)


def test_partition_roundtrip():
    """Three slabs stitched back are the object; a slab's halo rows are
    the next slab's first rows; both as the reference's."""
    g, arrays = tiling_problem(3)
    a = inputs(arrays)
    slabs, scan_loc, data_p, owned = tiling.partition_problem(
        arrays["psi_true"], a["scan"], a["data"], g, 3)
    np.testing.assert_array_equal(to_numpy(tiling.stitch(slabs, owned)),
                                  arrays["psi_true"])
    halo = g.nprb - 1
    assert torch.equal(slabs[0, :, owned:], slabs[1, :, :halo])
    ref = jpartition(arrays["psi_true"], a["scan"], a["data"], g, 3)
    np.testing.assert_array_equal(to_numpy(slabs), np.asarray(ref[0]))
    np.testing.assert_array_equal(
        np.asarray(jstitch(jnp.asarray(ref[0]), owned)), arrays["psi_true"])


def test_tiled_composed_with_scan_sharding(pools):
    """P3 x P1: each slab's positions sharded over its scan group (the
    object gradient summed over 'scan' before the halo exchange over
    'obj')."""
    g, arrays = tiling_problem(2, rows_per=2, cols=7)
    check_against_both(pools, (2, 2), g, inputs(arrays),
                       dict(piter=10, kernel="xla"))


def test_tiled_composed_joint_fused(pools):
    """The composition under joint recovery on the 'fused' tier: the probe
    gradient summed over both axes."""
    g, arrays = tiling_problem(2, cols=7)
    kw = dict(piter=6, recover_prb=True, kernel="fused")
    check_against_both(pools, (2, 2), g, inputs(arrays, 0.9), kw,
                       jax_kw=dict(kw, kernel="xla"))


def test_tiled_full_three_axis_mesh(pools):
    """P2 x P3 x P1 on a ('theta', 'obj', 'scan') mesh of 4 ranks: two
    angles, two slabs; the inner products over 'theta' and 'obj'."""
    g, arrays = tiling_problem(2, cols=7, ntheta=2)
    check_against_both(pools, (2, 2, 1), g, inputs(arrays),
                       dict(piter=8, kernel="xla"))


def test_tiled_carry_state_rejected(pools):
    g, arrays = tiling_problem(2)
    found = pools(2).run(_jobs.tiled_errors, (2,), geometry_from(g),
                         inputs(arrays),
                         [("run_tiled", dict(piter=2, carry_state=True))])[0]
    assert found[0][0] == "ValueError" and "carry_state" in found[0][1]
    with pytest.raises(ValueError, match="carry_state"):
        jrun_tiled(*(jnp.asarray(v) for v in inputs(arrays).values()), g,
                   jmake_obj_mesh(2), piter=2, carry_state=True)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_halo_exchange_matches_the_references_halo_fix(pools, n_slabs):
    """The pair-group broadcasts against the reference's two ppermutes
    (``tikejax.solvers.cg._halo_fix``) on random slabs, bit for bit (the
    only arithmetic is one add); each rank takes part in two broadcasts a
    pair it is in, of one (t, halo, n) strip each."""
    from jax.sharding import PartitionSpec as P

    from tikejax.solvers import cg as jcg

    t, owned, halo, n = 2, 9, 5, 7
    rng = np.random.default_rng(n_slabs)
    slabs = (rng.standard_normal((n_slabs, t, owned + halo, n))
             + 1j * rng.standard_normal((n_slabs, t, owned + halo, n)))
    opts = jcg.CGOptions(obj_axis_name="obj", obj_halo=halo,
                         obj_axis_size=n_slabs)
    ref = jax.shard_map(lambda x: jcg._halo_fix(x[0], opts)[None],
                        mesh=jmake_obj_mesh(n_slabs), in_specs=P("obj"),
                        out_specs=P("obj"))(jnp.asarray(slabs))
    results = pools(n_slabs).run(_jobs.halo, slabs, halo)
    strip = t * halo * n * 16
    for d, (x, launches, nbytes) in enumerate(results):
        np.testing.assert_array_equal(to_numpy(x), np.asarray(ref[d]))
        pairs = 1 if d in (0, n_slabs - 1) else 2
        assert (launches, nbytes) == (2 * pairs, 2 * pairs * strip)
    assert np.all(to_numpy(results[-1][0])[:, owned:] == 0)


def test_exchange_counters_follow_the_iterations(pools):
    """On the 'xla' classic object-only body each iteration makes one
    gradient pass, and the illumination map is made once: that many halo
    exchanges, two strips of (t, nprb - 1, n) a rank a pair (complex
    gradients, the real map)."""
    g, arrays = tiling_problem(2)
    got = port_tiled(pools, (2,), g, inputs(arrays),
                     dict(piter=5, kernel="xla", stop_on_stall=0))
    iters = int(got["out"][2]["iters_run"])
    strip = g.ntheta * (g.nprb - 1) * g.n
    assert got["halo"] == 2 * (iters + 1)
    assert got["halo_bytes"] == 2 * iters * strip * 16 + 2 * strip * 8


def test_meshes_and_entry_points_refuse_tiling_where_the_reference_does(
        pools):
    """``reconstruct(mesh=)`` refuses an 'obj' mesh and the obj_* fields
    (run_tiled-only), ``run_sharded`` the fields, a tiling mesh must span
    every rank and have an 'obj' dimension, and ``illum_lowk`` does not
    compose with tiling; without a mesh the obj axis raises naming
    run_tiled."""
    g, arrays = tiling_problem(2)
    a = inputs(arrays)
    cases = [("reconstruct", {}),
             ("reconstruct", dict(mesh="scan", obj_halo=2)),
             ("run_tiled", dict(mesh="scan")),
             ("mesh", dict(shape=(4,))),
             ("run_tiled", dict(precondition="illum_lowk"))]
    found = pools(2).run(_jobs.tiled_errors, (2,), geometry_from(g), a,
                         cases)
    assert all(f == found[0] for f in found)
    found = found[0]
    assert all(kind == "ValueError" for kind, _ in found), found
    assert "run_tiled-only" in found[0][1] and "run_tiled-only" in found[1][1]
    assert "expects a mesh with an 'obj' axis" in found[2][1]
    assert "need 4 devices" in found[3][1]
    assert "does not compose with object-domain tiling" in found[4][1]
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    with pytest.raises(ValueError, match="run_tiled"):
        tcg.run(t["data"], t["psi0"], t["scan"], t["prb"], geometry_from(g),
                piter=1, obj_axis_name="obj")
    found = pools(2).run(_jobs.errors, 2, geometry_from(g), a,
                         [("run_sharded", dict(kernel="xla",
                                               obj_axis_name="obj"))])[0]
    assert found[0][0] == "ValueError" and "run_tiled" in found[0][1]


def test_dryrun_p3_matches_one_process(pools):
    """The dry run's tiled step on a 2-slab ('obj',) mesh and a (2, 2)
    ('obj', 'scan') mesh against the one-process step, to its stated
    tolerance."""
    for n in (2, 4):
        errs = _dryrun.run_dryrun(n, pool=pools(n))["tiled"]
        assert errs["mesh"] == ((2,) if n == 2 else (2, 2))
        assert max(errs["psi"], errs["prb"], errs["minf"]) <= (
            _dryrun.DRYRUN_TOL)
        assert errs["halo"] > 0


def test_dryrun_three_axis_mesh_in_a_subprocess():
    """The 2 x 2 x 2 ('theta', 'obj', 'scan') step on 8 ranks, the
    reference's g4, in the dry run's subprocess."""
    from tikejax_torch.graft_entry import dryrun_multichip

    line = dryrun_multichip(8, timeout=2 * CASE_TIMEOUT)
    assert line.startswith("dryrun_multichip(8): OK") and (
        "tiled on (2, 2, 2)" in line)
