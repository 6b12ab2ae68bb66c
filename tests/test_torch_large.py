"""Large objects on the port: the slab fields' contract, objects that are
not square and sides that do not divide the tile scatter's 8 x 32 tile, and
the tile scatter's chunk boxes.

The JAX package answers its TPU's scoped-VMEM object cap with object row
slabs (``CGOptions.obj_slabs`` and the fields beside it): its fused kernels
stream the object slab by slab over a y-sorted, padded partition of the
positions, and its own tests hold a slab run to the whole-object run at
residual rtol 2e-4 and psi 1e-3 (``tests/test_slabs.py``). The port reads
the object from device memory whatever its size, so it validates the fields
as the JAX package does and then runs the whole object in the caller's scan
order: ``run(obj_slabs=D)`` is ``run()`` bit for bit, and it is held to the
JAX package's slab runs (interpret-mode Pallas on the CPU, started once per
module at ``tests/test_slabs.py``'s size) at those tolerances. Every
user-visible slab error of the JAX package is raised with its type and
message fragment.

The tile kernel skips each chunk of 256 positions of an angle's scan whose
box of corners (``kernels.scatter_box_plan``) misses its tile; the pure
test here shows with numpy that no (tile, position) pair whose windows meet
lies in a chunk the rule skips, for launches that start mid-angle as
``fused.frame_chunks`` cuts them. (``tests/test_torch_cuda.py`` holds the
kernel's bits with and without the skip on the card.)
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax import parallel as jparallel
from tikejax.models import make_problem
from tikejax.parallel import tiling as jtiling
from tikejax.solvers import reconstruct as jreconstruct
from tikejax.solvers import run as jrun
from tikejax_torch.ops import fused, kernels
from tikejax_torch.parallel import run_sharded, run_tiled
from tikejax_torch.solvers import reconstruct, run
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


# tests/test_slabs.py's problem(): the JAX package's slab tests' size.
GEOM = tikejax.Geometry(ntheta=1, nz=64, n=64, nscan=40, ndet=16, nprb=16)
# Its tolerances, slab run against the whole-object run.
RESIDUAL_RTOL, PSI_TOL = 2e-4, 1e-3
SLABS = 2


@pytest.fixture(scope="module")
def problem():
    """(data, psi0, scan, prb) as numpy: complex64 and float32, as
    tests/test_slabs.py casts them."""
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(0), GEOM)
    psi0 = np.ones(GEOM.psi_shape, np.complex64)
    return (np.asarray(data, np.float32), psi0, np.asarray(scan),
            np.asarray(prb, np.complex64))


@pytest.fixture(scope="module")
def jax_slab_runs(problem):
    """The JAX package's slab runs (kernel='fused_mp', interpret-mode
    Pallas), object-only and joint, computed on first use and shared."""
    cache = {}

    def get(joint):
        if joint not in cache:
            data, psi0, scan, prb = map(jnp.asarray, problem)
            kw = (dict(piter=6, recover_prb=True) if joint
                  else dict(piter=10))
            cache[joint] = jrun(data, psi0, scan, prb * 0.9 if joint else prb,
                                GEOM, model="gaussian", kernel="fused_mp",
                                obj_slabs=SLABS, **kw)
        return cache[joint]

    return get


def port_run(problem, joint=False, **kw):
    data, psi0, scan, prb = map(cpu, problem)
    if joint:
        kw = dict(kw, piter=6, recover_prb=True)
        prb = prb * 0.9
    return run(data, psi0, scan, prb, geometry_from(GEOM), **{
        "piter": 10, "model": "gaussian", "kernel": "fused_mp", **kw})


def assert_same_bits(a, b):
    (psi_a, prb_a, m_a), (psi_b, prb_b, m_b) = a, b
    assert torch.equal(psi_a, psi_b) and torch.equal(prb_a, prb_b)
    assert m_a.keys() == m_b.keys()
    for key, value in m_a.items():
        if torch.is_tensor(value):
            assert torch.equal(value, m_b[key]), key
        else:
            assert value == m_b[key], key


# -- the slab fields' contract -----------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(obj_slabs=2), dict(obj_slabs=3), dict(obj_slabs=4),
    dict(obj_slab_cols=2), dict(obj_slabs=4, obj_slab_cols=3,
                                kernel_frames=8),
    dict(obj_slabs=2, recover_prb=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_slab_run_is_the_whole_run_bit_for_bit(problem, kw):
    """A valid slab request runs the whole object in the caller's scan
    order: the same psi, probe and metrics, bit for bit, as the same call
    without it (object-only and joint; obj_slabs 3 does not divide the 64
    rows, which the JAX package's quantile partition also accepts)."""
    joint = kw.pop("recover_prb", False)
    assert_same_bits(port_run(problem, joint, **kw),
                     port_run(problem, joint))


@pytest.mark.parametrize("joint", [False, True], ids=["object", "joint"])
def test_slab_run_matches_the_jax_slab_run(problem, jax_slab_runs, joint):
    """The counterparts of tests/test_slabs.py's
    test_solver_slab_equivalence and test_solver_slab_joint_recovery: the
    port's slab run follows the JAX package's slab run (its partition
    reorders and pads the positions; its 'fused_mp' tier runs bf16 passes)
    at the JAX tests' tolerances."""
    psi_j, prb_j, m_j = jax_slab_runs(joint)
    psi_t, prb_t, m_t = port_run(problem, joint, obj_slabs=SLABS)
    n = int(m_j["iters_run"])
    assert int(m_t["iters_run"]) == n
    np.testing.assert_allclose(to_numpy(m_t["residual"]),
                               np.asarray(m_j["residual"]),
                               rtol=RESIDUAL_RTOL)
    for got, want in ((psi_t, psi_j), (prb_t, prb_j)):
        want = np.asarray(want)
        assert (np.linalg.norm(to_numpy(got) - want)
                / np.linalg.norm(want)) < PSI_TOL


RECONSTRUCT = dict(target_residual=3e-4, segment=12, max_segments=8,
                   fast_kernel="fused", base_kernel="fused_hp",
                   tiers=(("fused", 5e-3, 64),))


def test_slab_reconstruct_is_the_whole_reconstruct(problem):
    """reconstruct(obj_slabs=2) on fused stage kernels (which the JAX
    package's driver requires) gives the whole-object reconstruct's stages
    and object, bit for bit."""
    args = (*map(cpu, problem), geometry_from(GEOM))
    psi_s, _, stages_s = reconstruct(*args, obj_slabs=2, **RECONSTRUCT)
    psi_w, _, stages_w = reconstruct(*args, **RECONSTRUCT)
    assert torch.equal(psi_s, psi_w)
    assert [n for n, _ in stages_s] == [n for n, _ in stages_w]
    assert any(n.startswith("split:") for n, _ in stages_w)
    for (_, a), (_, b) in zip(stages_s, stages_w):
        assert int(a["iters_run"]) == int(b["iters_run"])
        assert torch.equal(a["residual"], b["residual"])


def _mesh_call(which, port):
    """run_sharded, run_tiled or reconstruct on a mesh: the JAX package's
    on a 2-device CPU mesh; the port's with a stand-in for its mesh, since
    its slab checks come before any use of the mesh (every rank would make
    them)."""
    if which == "reconstruct":
        mesh = object() if port else jparallel.make_mesh(2)
        return lambda *a, **kw: (reconstruct if port else jreconstruct)(
            *a, target_residual=1e-3, mesh=mesh, fast_kernel="fused",
            base_kernel="fused_hp", **kw)
    if which == "run_sharded":
        mesh = None if port else jparallel.make_mesh(2)
        fn = run_sharded if port else jparallel.run_sharded
    else:
        mesh = None if port else jtiling.make_obj_mesh(2)
        fn = run_tiled if port else jtiling.run_tiled
    return lambda d, p0, s, pr, g, **kw: fn(d, p0, s, pr, g, mesh,
                                            kernel="fused_mp", **kw)


# (entry, keywords, exception type, message fragment): the JAX package's
# user-visible slab errors (its _Engine's checks, run()'s column check and
# its driver's stage-kernel check).
ERRORS = {
    "slabs-below-1": ("run", dict(kernel="fused_mp", obj_slabs=0),
                      ValueError, "obj_slabs must be >= 1"),
    "xla": ("run", dict(kernel="xla", obj_slabs=2), ValueError,
            "fused kernel"),
    "pallas": ("run", dict(kernel="pallas", obj_slabs=2), ValueError,
               "fused kernel"),
    "auto-off-the-card": ("run", dict(obj_slabs=2), ValueError,
                          "fused kernel"),
    "materialized": ("run", dict(kernel="fused_mp", obj_slabs=2,
                                 memory="materialized"), ValueError,
                     "frameless"),
    "nchunks": ("run", dict(kernel="fused_mp", obj_slabs=2, nchunks=2),
                ValueError, "nchunks"),
    "cols-below-1": ("run", dict(kernel="fused_mp", obj_slab_cols=0),
                     ValueError, "obj_slab_cols must be >= 1"),
    "run_sharded": ("run_sharded", dict(obj_slabs=2), ValueError,
                    "run_tiled"),
    "run_tiled": ("run_tiled", dict(obj_slabs=2), ValueError, "run_tiled"),
    "reconstruct-mesh": ("reconstruct-mesh", dict(obj_slabs=2), ValueError,
                         "run_tiled"),
    "reconstruct-oracle": ("reconstruct", dict(obj_slabs=2), ValueError,
                           "every driver stage kernel"),
    "reconstruct-pallas": ("reconstruct", dict(
        obj_slabs=2, fast_kernel="pallas", base_kernel="fused_hp"),
        ValueError, "every driver stage kernel"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_slab_errors_are_the_references(problem, case):
    """Each of the JAX package's user-visible slab errors: both packages
    raise the same exception type, and both messages hold its fragment."""
    entry, kw, error, fragment = ERRORS[case]
    found = []
    for port in (False, True):
        if entry == "run":
            fn = run if port else jrun
            kw_e = dict(kw, piter=2)
        elif entry == "reconstruct":
            fn = reconstruct if port else jreconstruct
            kw_e = dict(kw, target_residual=1e-3)
        else:
            fn = _mesh_call(entry.removesuffix("-mesh"), port)
            kw_e = dict(kw, piter=2) if entry != "reconstruct-mesh" else kw
        arrays = map(cpu if port else jnp.asarray, problem)
        g = geometry_from(GEOM) if port else GEOM
        with pytest.raises(Exception) as err:
            fn(*arrays, g, **kw_e)
        found.append(err.value)
    for e in found:
        assert type(e) is error and re.search(re.escape(fragment), str(e)), (
            case, type(e), str(e))


# -- objects that are not square, sides off the tile ----------------------

# Sides that do not divide the tile scatter's 8 x 32 tile (200 = 25 x 8 but
# 200 / 32 is not whole; 72 / 32 neither), tall and wide.
ODD_SHAPES = [dict(nz=200, n=72), dict(nz=72, n=200)]


@pytest.fixture(scope="module")
def odd_problems():
    out = {}
    for i, shape in enumerate(ODD_SHAPES):
        g = tikejax.Geometry(nscan=30, ndet=32, nprb=24, **shape)
        psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(5 + i), g,
                                                 dtype=jnp.complex128)
        psi0 = np.ones(g.psi_shape, np.complex128)
        out[g.nz, g.n] = (g, tuple(np.asarray(x)
                                   for x in (data, psi0, scan, prb)))
    return out


@pytest.mark.parametrize("kernel, tol", [("xla", 1e-8), ("fused_mx", 1e-7)],
                         ids=["oracle", "merged"])
@pytest.mark.parametrize("shape", ODD_SHAPES,
                         ids=lambda s: f"{s['nz']}x{s['n']}")
def test_non_square_objects_match_jax(odd_problems, shape, kernel, tol):
    """run on an object that is not square, of sides off the tile, against
    the JAX package's 'xla' run in fp64 (backtracking): the oracle path to
    1e-8; the port's merged path (the fused tiers' plain versions) to 1e-7,
    as tests/test_torch_cg.py holds it -- it evaluates the same candidates
    through the gradient pass, the JAX classic body through statistics."""
    g, problem = odd_problems[shape["nz"], shape["n"]]
    pj, _, mj = jrun(*map(jnp.asarray, problem), g, piter=12, kernel="xla",
                     linesearch="backtracking")
    pt, _, mt = run(*map(cpu, problem), geometry_from(g), piter=12,
                    kernel=kernel, linesearch="backtracking")
    n = int(mj["iters_run"])
    assert int(mt["iters_run"]) == n and n > 1
    for key in ("minf", "residual", "gamma"):
        np.testing.assert_allclose(to_numpy(mt[key]), np.asarray(mj[key]),
                                   rtol=tol, atol=0, err_msg=key)
    pj = np.asarray(pj)
    assert pt.shape == (1, g.nz, g.n)
    assert np.abs(to_numpy(pt) - pj).max() <= tol * np.abs(pj).max()


# -- the tile scatter's chunk boxes -----------------------------------------

def boxes_by_numpy(scan, nz, n, p, chunk):
    """(t, chunks, 4) (ymin, xmin, ymax, xmax) of each chunk's valid
    corners; None for a chunk with none."""
    t, s, _ = scan.shape
    out = []
    for th in range(t):
        row = []
        for c0 in range(0, s, chunk):
            part = scan[th, c0:c0 + chunk]
            ok = ((part[:, 0] >= 0) & (part[:, 0] <= nz - p)
                  & (part[:, 1] >= 0) & (part[:, 1] <= n - p))
            v = part[ok]
            row.append(None if len(v) == 0 else (
                v[:, 0].min(), v[:, 1].min(), v[:, 0].max(), v[:, 1].max()))
        out.append(row)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_chunk_boxes_keep_every_hit(seed):
    """On random scans (clustered bands, masked rows, corners out of the
    object, two angles) the boxes equal a numpy reckoning, and every
    (tile, position) pair whose windows meet lies in a chunk the kernel's
    rule does not skip, in every launch of ``fused.frame_chunks`` (chunks
    of frames that start mid-angle, past a 256-position chunk's start): a
    launch on positions [a, b) walks the chunks a // 256 ... of the whole
    scan's boxes, as the kernel does."""
    rng = np.random.default_rng(seed)
    t, s, nz, n, p = 2, 700, 77, 101, 13
    scan = np.stack([rng.integers(-3, nz - p + 4, (t, s)),
                     rng.integers(-3, n - p + 4, (t, s))], -1)
    scan[:, 300:420, 0] = rng.integers(0, 10, (t, 120))  # a band of rows
    scan[:, rng.choice(s, 40, replace=False), 0] = -1   # masked
    scan = scan.astype(np.int32)
    c = kernels.SCATTER_CHUNK
    got = kernels.scatter_box_plan(torch.from_numpy(scan), nz, n, p).numpy()
    want = boxes_by_numpy(scan, nz, n, p, c)
    for th in range(t):
        for k, box in enumerate(want[th]):
            if box is None:  # meets no tile
                assert got[th, k, 0] >= nz and got[th, k, 2] + p <= 0
            else:
                assert tuple(got[th, k]) == box
    th_tiles = kernels.SCATTER_TILE
    tiles_y, tiles_x, _ = kernels.scatter_tile_plan(t, nz, n)
    y0 = np.arange(tiles_y) * th_tiles[0]
    x0 = np.arange(tiles_x) * th_tiles[1]
    y1, x1 = np.minimum(y0 + th_tiles[0], nz), np.minimum(x0 + th_tiles[1], n)
    for _, _, segments in fused.frame_chunks(t, s, 333):
        for th0, th1, a, b in segments:
            for th in range(th0, th1):
                for i in range(a, b):
                    y, x = scan[th, i]
                    if not (0 <= y <= nz - p and 0 <= x <= n - p):
                        continue  # adds nothing; the kernel never lists it
                    box = got[th, i // c]  # the chunk the walk puts i in
                    meets_y = (y < y1) & (y + p > y0)
                    meets_x = (x < x1) & (x + p > x0)
                    live_y = (box[0] < y1) & (box[2] + p > y0)
                    live_x = (box[1] < x1) & (box[3] + p > x0)
                    assert not np.any(meets_y & ~live_y)
                    assert not np.any(meets_x & ~live_x)


@pytest.mark.parametrize("nz, s", [(1024, 16384), (2048, 16384),
                                   (1024, 65536)],
                         ids=["1024", "2048", "64k"])
def test_large_shapes_stay_in_range(nz, s):
    """The reckoning of the sizes on the path at the JAX package's large
    configurations (128^2 probe and detector, one mode): the tile plan's
    blocks fit one grid dimension; grad_fused's frame chunks are 4,096
    frames (the 512 MiB scratch), each one launch of the tile kernel on
    positions [a, a + 4096) of the one angle, a a multiple of the walk's
    256; the chunk boxes, one per 256 positions; the raster scan's corners
    lie in the object and are distinct (its step at 2048^2 is 15.1
    pixels). (The frames of 65,536 positions hold 2^31 floats: the kernels
    form their offsets in 64 bits, which phase large of chip_smoke.py
    holds on the card.)"""
    from tikejax_torch.models.simulate import raster_scan

    tiles_y, tiles_x, blocks = kernels.scatter_tile_plan(1, nz, nz)
    assert (tiles_y, tiles_x) == (nz // 8, nz // 32)
    assert blocks == nz * nz // 256 < 2**31 - 1
    chunk = fused.frame_chunk(1, 128)
    assert chunk * 128 * 128 * 8 == fused.FRAME_SCRATCH_BYTES
    plan = fused.frame_chunks(1, s, chunk)
    assert [seg for _, _, seg in plan] == [
        [(0, 1, a, a + chunk)] for a in range(0, s, chunk)]
    assert chunk % kernels.SCATTER_CHUNK == 0
    g = tikejax.Geometry(nz=nz, n=nz, nscan=s, ndet=128, nprb=128)
    scan = raster_scan(None, geometry_from(g), jitter=0, device="cpu")
    corners = scan.round().to(torch.int32)
    assert int(corners.min()) == 0 and int(corners.max()) == nz - 128
    assert len(torch.unique(corners[0], dim=0)) == s
    boxes = kernels.scatter_box_plan(corners, nz, nz, 128)
    assert boxes.shape == (1, s // kernels.SCATTER_CHUNK, 4)
    assert int(boxes.min()) == 0 and int(boxes.max()) == nz - 128
