"""``scatter_conj_probe``'s tile kernel, what can be pinned without a card:
the plan that cuts the object into tiles (every pixel in exactly one tile,
the threads dividing each tile), the forced-variant check made before any
launch, and the plain version on CPU tensors (``tests/test_torch_package.py``
holds the entry points the wrapper binds against the C source). The kernel
itself is held on the card in ``tests/test_torch_cuda.py``."""

import inspect
import re
from pathlib import Path

import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from tikejax_torch import Geometry
from tikejax_torch.models import make_problem
from tikejax_torch.ops import kernels
from tikejax_torch.ops.patches import scan_to_int

CSRC = Path(kernels.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("t, nz, n", [
    (1, 512, 512), (2, 97, 101), (2, 97, 102), (1, 64, 64), (3, 15, 33),
    (1, 1, 1), (2, 200, 180), (1, 8, 32), (1, 9, 33), (4, 7, 31),
    (1, 513, 511), (2, 101, 102), (1, 48, 55), (3, 56, 48)])
def test_tile_plan_covers_every_pixel_once(t, nz, n):
    th, tw = kernels.SCATTER_TILE
    tiles_y, tiles_x, blocks = kernels.scatter_tile_plan(t, nz, n)
    assert blocks == t * tiles_y * tiles_x
    # The last tile of each axis is partial, but not empty.
    assert (tiles_y - 1) * th < nz <= tiles_y * th
    assert (tiles_x - 1) * tw < n <= tiles_x * tw
    hits = torch.zeros((nz, n), dtype=torch.int32)
    for u in range(tiles_y * tiles_x):
        ty, tx = divmod(u, tiles_x)
        hits[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
    assert bool((hits == 1).all())


def test_tile_plan_at_the_headline_and_past_the_grid_limit():
    """One block per (angle, tile); a plan whose blocks would pass the
    grid's limit raises instead of launching fewer."""
    assert kernels.scatter_tile_plan(1, 512, 512) == (64, 16, 1024)
    assert kernels.scatter_tile_plan(4, 512, 512) == (64, 16, 4096)
    with pytest.raises(ValueError, match="grid's limit"):
        kernels.scatter_tile_plan(70000, 8192, 8192)


def test_threads_own_one_pixel_of_the_tile_each():
    """256 threads own a tile, one pixel each and a warp a tile row; the
    tile is the one the kernel is built for (its launch checks the plan's
    tile counts against it)."""
    th, tw = kernels.SCATTER_TILE
    assert th * tw == 256 and tw == 32
    text = (CSRC / "scatter_conj_probe.cu").read_text()
    assert re.search(rf"constexpr int kTileH = {th}, kTileW = {tw};", text)


@pytest.mark.parametrize("nmodes, chunk", [
    (1, 1), (2, 2), (3, 4), (4, 4), (5, 4), (8, 4)])
def test_mode_chunk_covers_the_modes(nmodes, chunk):
    """A position's modes are loaded ``scatter_mode_chunk`` at a time, in
    order: the chunks cover every mode once, the last one partly empty
    where the chunk does not divide the modes."""
    got = kernels.scatter_mode_chunk(nmodes)
    assert got == chunk and got in (1, 2, 4)
    chunks = [list(range(m0, min(m0 + got, nmodes)))
              for m0 in range(0, nmodes, got)]
    assert sum(chunks, []) == list(range(nmodes))


def test_scatter_variant_is_checked_before_any_launch():
    """The private wrapper launches the tile kernel unless
    ``variant='atomic'`` forces the one it replaced; any other variant
    raises before anything reaches a device, even on CPU tensors."""
    params = inspect.signature(kernels._scatter_conj_probe_cuda).parameters
    assert params["variant"].default is None
    assert kernels._scatter_variant(None) == "tile"
    assert kernels._scatter_variant("atomic") == "atomic"
    for bad in ("tile", "pixel", "fft"):
        with pytest.raises(ValueError, match="unknown variant"):
            kernels._scatter_variant(bad)
    near = torch.ones((1, 2, 1, 4, 4), dtype=torch.complex64)
    prb = torch.ones((1, 1, 4, 4), dtype=torch.complex64)
    scan = torch.zeros((1, 2, 2), dtype=torch.int32)
    launches = kernels.scatter_conj_probe.launches
    with pytest.raises(ValueError,
                       match="scatter_conj_probe: unknown variant"):
        kernels._scatter_conj_probe_cuda(near, scan, prb, 16, 16,
                                         variant="fast")
    assert kernels.scatter_conj_probe.launches == launches


def test_tile_kernel_has_no_atomics():
    """Each pixel is stored once: the tile kernel's body holds no atomic;
    only the atomic kernel it replaced scatters with atomics."""
    text = (CSRC / "scatter_conj_probe.cu").read_text()
    start = text.index("scatter_conj_probe_tile_kernel(Params q)")
    body = text[start:text.index("using Int = std::integral_constant")]
    assert "atomic" not in body.lower() and "scatter_add_pixel" not in body
    assert "scatter_add_pixel" in text[text.index(
        "scatter_conj_probe_atomic_kernel(Params q)"):]


def test_scatter_on_cpu_runs_the_plain_version():
    """On CPU tensors ``scatter_conj_probe`` runs the plain version: no
    kernel launches, no variant is recorded, and the result is the plain
    version's (to its own summation order: PyTorch's ``index_add_`` on
    several threads does not fix it)."""
    g = Geometry(nz=41, n=43, nscan=7, ndet=20, nprb=12, ntheta=2,
                 nmodes=2)
    gen = torch.Generator().manual_seed(5)
    _, scan, prb, _ = make_problem(gen, g, device="cpu")
    scan_i = scan_to_int(scan)
    scan_i[1, 3, 0] = -1
    far = torch.complex(torch.randn(g.farplane_shape, generator=gen),
                        torch.randn(g.farplane_shape, generator=gen))
    near = far[..., :g.nprb, :g.nprb]
    fns = (kernels.scatter_conj_probe, kernels.scatter_conj_probe_reference)
    before = [fn.launches for fn in fns]
    variant = kernels.scatter_conj_probe.variant
    got = kernels.scatter_conj_probe(near, scan_i, prb, g.nz, g.n)
    ref = kernels.scatter_conj_probe_reference(near, scan_i, prb, g.nz, g.n)
    assert got.shape == g.psi_shape and got.dtype == torch.complex64
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert [fn.launches - b for fn, b in zip(fns, before)] == [0, 2]
    assert kernels.scatter_conj_probe.variant == variant
