"""The fused tiers' object adjoint ``adj`` in scan order, what can be pinned
without a card: its kernel stores the cropped inverse frames of a chunk of
positions and ``scatter_conj_probe``'s tile kernel sums each chunk into the
object, continuing from the partial object the chunk before stored. On the
CPU the plain versions do the same in the same order, so the result is the
same bits whatever the chunk; the kernels themselves are held on the card
in ``tests/test_torch_cuda.py``."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from tikejax_torch import Geometry  # noqa: E402
from tikejax_torch.models import make_problem  # noqa: E402
from tikejax_torch.ops import diffraction, fused, kernels  # noqa: E402
from tikejax_torch.ops.patches import scan_to_int  # noqa: E402

CSRC = Path(fused.__file__).resolve().parents[1] / "csrc"
SMALL = Geometry(nz=41, n=43, nscan=23, ndet=20, nprb=12, ntheta=2,
                 nmodes=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the plain scatter's ``index_add_`` then adds in
    index order, which is scan order; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def problem(dtype=torch.complex64):
    gen = torch.Generator().manual_seed(11)
    _, scan, prb, _ = make_problem(gen, SMALL, device="cpu")
    scan_i = scan_to_int(scan)
    scan_i[1, 4, 0] = -1  # masked dummies, at the start of a chunk too
    scan_i[0, 9, 0] = -1
    far = torch.complex(torch.randn(SMALL.farplane_shape, generator=gen),
                        torch.randn(SMALL.farplane_shape, generator=gen))
    return far.to(dtype), scan_i, prb.to(dtype)


def test_chunk_budget():
    """The frame scratch stays within FRAME_SCRATCH_BYTES: the stream
    path's 1024-frame chunk of 128^2 fits whole, one mode of the headline
    takes 4 chunks and the 4-mode 16384 x 128^2 farplane 16 (not 8 GiB at
    once)."""
    budget = fused.FRAME_SCRATCH_BYTES
    assert budget == 512 * 2**20
    assert fused.adj_chunk(1, 1024, 1, 128) == 1024
    assert fused.adj_chunk(1, 16384, 1, 128) == 4096
    assert fused.adj_chunk(1, 16384, 4, 128) == 1024
    for t, s, m, p in ((1, 16384, 4, 128), (2, 37, 2, 48), (3, 5, 1, 1)):
        chunk = fused.adj_chunk(t, s, m, p)
        assert 1 <= chunk <= s and t * chunk * m * p * p * 8 <= budget
    # A position larger than the budget still makes a chunk of one.
    assert fused.adj_chunk(1, 10, 1, 2**14) == 1


def chunked_adj(far, scan_i, prb, chunk):
    """The kernels' two stages in their plain versions: the oracle's
    cropped inverse frames of each chunk of positions, summed into the
    object by the plain ``scatter_conj_probe`` continuing from the partial
    object of the chunks before."""
    from tikejax_torch.ops.fft import crop_from_det, ifft2o

    out = None
    for c0 in range(0, SMALL.nscan, chunk):
        part = slice(c0, c0 + chunk)
        near = crop_from_det(ifft2o(far[:, part]), SMALL.nprb)
        out = kernels.scatter_conj_probe_reference(
            near, scan_i[:, part], prb, SMALL.nz, SMALL.n, out=out)
    return out


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("chunk", [1, 2, 5, 9, 22])
def test_plain_adj_is_the_same_bits_whatever_the_chunk(chunk, dtype):
    far, scan_i, prb = problem(dtype)
    whole = chunked_adj(far, scan_i, prb, SMALL.nscan)
    got = chunked_adj(far, scan_i, prb, chunk)
    assert got.dtype == dtype and torch.equal(got, whole)
    # One pass is the plain adj, the oracle adjoint, bit for bit.
    assert torch.equal(whole, fused.adj_reference(far, scan_i, prb, SMALL.nz,
                                                  SMALL.n))


def test_scatter_continues_from_the_stored_partial():
    """``scatter_conj_probe``'s plain version with ``out``: the positions in
    two calls, the second adding into what the first stored, are the bits
    of one call; ``out`` is written in place and returned."""
    far, scan_i, prb = problem()
    near = far[..., :SMALL.nprb, :SMALL.nprb]
    one = kernels.scatter_conj_probe_reference(near, scan_i, prb, SMALL.nz,
                                               SMALL.n)
    for cut in (1, 8, 17):
        out = kernels.scatter_conj_probe_reference(
            near[:, :cut], scan_i[:, :cut], prb, SMALL.nz, SMALL.n)
        again = kernels.scatter_conj_probe_reference(
            near[:, cut:], scan_i[:, cut:], prb, SMALL.nz, SMALL.n, out=out)
        assert again is out and torch.equal(out, one)


def test_adj_on_cpu_runs_the_plain_version():
    far, scan_i, prb = problem()
    before = (fused.adj.launches, fused.adj_reference.launches)
    got = fused.adj(far, scan_i, prb, SMALL.nz, SMALL.n)
    assert (fused.adj.launches, fused.adj_reference.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(got, fused.adj_reference(far, scan_i, prb, SMALL.nz,
                                                SMALL.n))


def test_adj_variants_are_checked_before_any_launch():
    """'atomic' forces the FFT kernel this design replaced and so takes
    only the FFT sizes; a chunk below one raises; both before anything
    reaches a device."""
    far, scan_i, prb = problem()
    launches = fused.adj.launches
    with pytest.raises(ValueError, match="'fft' variant takes ndet"):
        fused._adj_cuda(far, scan_i, prb, SMALL.nz, SMALL.n,
                        variant="atomic")
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        fused._adj_cuda(far, scan_i, prb, SMALL.nz, SMALL.n, chunk=0)
    assert fused.adj.launches == launches


def test_adj_frame_kernels_store_and_only_the_replaced_one_scatters():
    """The frame kernels write the crop and hold no atomic; only the
    forced atomic kernel scatters; the tile kernel has a continue-from-
    the-stored-partial entry."""
    text = (CSRC / "adj.cu").read_text()
    gemm = text[text.index("adj_kernel(Params q)"):
                text.index("// -- the FFT variant")]
    assert "scatter_add_pixel" not in gemm and "atomic" not in gemm.lower()
    assert re.search(r"if constexpr \(kAtomic\) \{\s*// Ends with a barrier",
                     text)
    assert "adj_fft_body<kD, kT, false>(q)" in text
    assert "adj_atomic_fft_kernel" in text
    tile = (CSRC / "scatter_conj_probe.cu").read_text()
    # The pixel continues from the running sum in double that the chunk
    # before left in `part`.
    assert "bool started = !q.from_partial;" in tile
    assert "if (inside) acc = *part;" in tile


# -- grad_fused and adj_residual in scan order: the plan and the sources ----

@pytest.mark.parametrize("t,s,chunk", [(1, 16384, 256), (1, 10, 3),
                                       (3, 4, 5), (2, 37, 37), (2, 37, 74),
                                       (3, 5, 1), (4, 6, 100)])
def test_frame_chunks_cover_every_frame_once_in_scan_order(t, s, chunk):
    """The chunks are consecutive frames (angle-major, as the frame
    kernels number them), of ``chunk`` frames but the last; their tile
    segments cover each angle's positions once, in increasing order, and
    continue from (and leave) running sums exactly where an angle is
    split."""
    plan = fused.frame_chunks(t, s, chunk)
    seen = {th: [] for th in range(t)}
    g_next = 0
    for g0, g1, segments in plan:
        assert g0 == g_next and 0 < g1 - g0 <= chunk
        g_next = g1
        frames = 0
        for th0, th1, a, b in segments:
            assert 0 <= a < b <= s and th1 > th0
            assert th1 - th0 == 1 or (a, b) == (0, s)
            frames += (th1 - th0) * (b - a)
            for th in range(th0, th1):
                seen[th].append((a, b))
        assert frames == g1 - g0
    assert g_next == t * s
    for th in range(t):
        spans = seen[th]
        assert spans[0][0] == 0 and spans[-1][1] == s
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        fused.frame_chunks(t, s, 0)


def test_frame_chunk_budget():
    """The frame scratch of grad_fused and adj_residual stays within
    FRAME_SCRATCH_BYTES: 4096 frames of one mode at 128^2 (the headline in
    4 chunks), 1024 at 4 modes."""
    assert fused.FRAME_SCRATCH_BYTES == 512 * 2**20
    assert fused.frame_chunk(1, 128) == 4096
    assert fused.frame_chunk(4, 128) == 1024
    for m, p in ((1, 128), (2, 48), (3, 100), (1, 1)):
        chunk = fused.frame_chunk(m, p)
        assert chunk >= 1 and chunk * m * p * p * 8 <= fused.FRAME_SCRATCH_BYTES
    assert fused.frame_chunk(1, 2**14) == 1


def test_only_the_forced_atomic_kernels_scatter_with_atomics():
    """scatter_add_pixel (fp32 atomics) is reached only by the one-pass
    kernels kept for timing (scatter_patch, the scatter's atomic kernel):
    grad_fused's and adj_residual's frame kernels store the crop, their
    GEMM kernels hold no atomic, and scatter_patch appears in each only
    under kAtomic."""
    def code(name):  # the source without its comments
        return "\n".join(line.split("//")[0] for line in
                         (CSRC / name).read_text().splitlines())

    header = code("dft_frame.cuh")
    assert header.count("scatter_add_pixel(") == 2  # definition, scatter_patch
    for name in ("grad_fused", "adj_residual", "adj"):
        text = code(f"{name}.cu")
        assert "scatter_add_pixel" not in text, name
        gemm = text[text.index(f"{name}_kernel(Params q)"):
                    text.index("struct FftParams")]
        assert "scatter_patch" not in gemm and "atomic" not in gemm, name
        assert text.count("scatter_patch<kD, kT>(") == text.count(
            "if constexpr (kAtomic) {"), name
        assert f"tk_{name}_atomic_fft(" in text, name
    for name in ("grad_fused", "adj_residual"):
        text = code(f"{name}.cu")
        assert "store_crop<kD, kT>(" in text and "Range{g0, g1" in text
    tile = code("scatter_conj_probe.cu")
    body = tile[tile.index("scatter_conj_probe_tile_kernel(Params q)"):
                tile.index("using Int = std::integral_constant")]
    assert "double2 acc" in body and "atomic" not in body.lower()


@pytest.mark.parametrize("name", ["grad_fused", "adj_residual"])
def test_two_pass_options_are_checked_before_any_launch(name):
    """'atomic' forces the FFT kernel this design replaced and so takes
    only the FFT sizes (grad_fused's no base); a chunk below one raises;
    all before anything reaches a device."""
    g = SMALL
    gen = torch.Generator().manual_seed(3)
    psi, scan, prb, data = make_problem(gen, g, device="cpu")
    scan_i = scan_to_int(scan)
    far = torch.zeros(g.farplane_shape, dtype=torch.complex64)
    counter = getattr(fused, name)
    launches = counter.launches

    def call(**kw):
        if name == "grad_fused":
            return fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                          "gaussian", kw.pop("base", None),
                                          **kw)
        return fused._adj_residual_cuda(far, data, scan_i, prb, g.nz, g.n,
                                        "gaussian", **kw)

    with pytest.raises(ValueError, match="'fft' variant takes ndet"):
        call(variant="atomic")
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        call(chunk=0)
    if name == "grad_fused":
        with pytest.raises(ValueError, match="no base"):
            call(variant="atomic", base=far)
    assert counter.launches == launches


def test_tile_partial_sums_are_checked_before_any_launch():
    """Keeping or continuing running sums needs a complex128 ``partial``
    of the object's shape."""
    near = torch.ones((1, 2, 1, 4, 4), dtype=torch.complex64)
    prb = torch.ones((1, 1, 4, 4), dtype=torch.complex64)
    scan = torch.zeros((1, 2, 2), dtype=torch.int32)
    launches = kernels.scatter_conj_probe.launches
    for kw in ({"last": False}, {"from_partial": True}):
        with pytest.raises(ValueError, match="needs partial"):
            kernels._scatter_conj_probe_cuda(near, scan, prb, 16, 16, **kw)
    with pytest.raises(ValueError, match="partial must be a contiguous"):
        kernels._scatter_conj_probe_cuda(
            near, scan, prb, 16, 16, last=False,
            partial=torch.zeros((1, 16, 16), dtype=torch.complex64))
    assert kernels.scatter_conj_probe.launches == launches
