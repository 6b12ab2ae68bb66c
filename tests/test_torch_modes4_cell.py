"""The benchmark's multi-mode cell (``h100bench``, cell
``modes4-512-16k.jobs``: ``BASELINE.json`` configs[3], 4 incoherent probe
modes, 16,384 positions) and the scan-order path it runs at 4 modes:
``ops.fused``'s object gradient in chunks of frames, each a frame-kernel
launch (span ``fused.frame_pass``) and the tile scatter (span
``fused.tile_scatter``), counted in frames x modes.

On the CPU: the tiny cell against the plain complex128 reference, and the
same judge refusing the program when it is handed 3 of the 4 modes; the
cell's routing at its full size; and the chunk path itself
(``fused._scan_order``) with plain stand-ins for its two kernels, which
gives one chunk's bits over chunks that split an angle. The tests marked
``cuda`` run the real kernels on the card (this file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_modes4_cell.py
"""

import ctypes
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from h100bench import frame_spans, harness, roofline, spec  # noqa: E402
from h100bench.reference import cg as ref_cg  # noqa: E402
from h100bench.reference import cg_restart  # noqa: E402
from h100bench.reference.ptycho import Ptycho  # noqa: E402
from h100bench.tests import tiny  # noqa: E402
from tikejax_torch import Geometry  # noqa: E402
from tikejax_torch.models import likelihoods, make_problem  # noqa: E402
from tikejax_torch.ops import diffraction, fused, kernels  # noqa: E402
from tikejax_torch.ops.fft import crop_from_det, ifft2o  # noqa: E402
from tikejax_torch.ops.patches import scan_to_int  # noqa: E402
from tikejax_torch.utils import profiling  # noqa: E402
from tikejax_torch.utils.profiling import span_report  # noqa: E402

CELL = "modes4-512-16k.jobs"
CONFIG = json.loads(
    (ROOT / "h100bench" / "configs" / "modes4-512-16k.json").read_text())
SPANS = ("fused.frame_pass", "fused.tile_scatter")
# Against the complex128 reference: float32 frames, FFTs and crops, their
# sums kept in double and rounded once; about 1e-6 of the gradient's scale
# is what the rounding leaves, 1e-5 the bound.
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the cell -----------------------------------------------------------


@pytest.mark.parametrize("traced", [False, True])
def test_the_tiny_cell_is_correct(traced):
    """The cell at ``tiny``'s size (4 modes kept) on the CPU options of
    the jobs mix: correct against the plain reference; off the card only
    the host's numbers and, traced, the CG loop's two program counters,
    none of the six readings of the card's trace."""
    result = tiny.execute(CELL, traced=traced)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"psi_err", "residual_err"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert tiny.cell(CELL).config["nmodes"] == 4
    if traced:
        assert set(result["metrics"]) == {"cg.evals_per_iter.jobs",
                                          "cg.host_syncs_per_iter.jobs"}
    else:
        assert set(result["metrics"]) == {"cg_iters_per_s", "job_s_p90",
                                          "setup_s"}


def test_a_program_that_drops_a_mode_fails_the_cell():
    """The program handed the first 3 of the 4 modes, on data made from
    4, against the same reference and limits: the judge refuses it."""
    program = harness.load_program()
    real = program.solvers.run

    def three_modes(data, psi0, scan, prb, geometry, **kw):
        return real(data, psi0, scan, prb[:, :3].contiguous(),
                    dataclasses.replace(geometry, nmodes=3), **kw)

    dropped = types.SimpleNamespace(
        **dict(vars(program), solvers=types.SimpleNamespace(run=three_modes)))
    torch.manual_seed(0)
    result = harness.execute(tiny.cell(CELL), tiny.SEED, 0.3, False,
                             torch.device("cpu"), dropped,
                             time.perf_counter())
    assert not result["correct"], result["checks"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("what, value", [
    ("variant", "fft"),
    ("body", "fft_smem"),
    ("chunk", 1024),
    ("chunks", 16),
])
def test_the_cell_routes_to_the_shared_memory_body_in_16_chunks(what,
                                                                 value):
    """At the configuration's own sizes: the FFT variant on its
    shared-memory body (the fused body takes one mode), 1,024 frames of 4
    modes a chunk (512 MiB of crops), 16 chunks of the 16,384 positions."""
    m, d, p = CONFIG["nmodes"], CONFIG["ndet"], CONFIG["nprb"]
    got = {
        "variant": lambda: fused.dft_variant(p, d, m),
        "body": lambda: fused.fft_body(d, m),
        "chunk": lambda: fused.frame_chunk(m, p),
        "chunks": lambda: len(fused.frame_chunks(
            CONFIG["ntheta"], CONFIG["nscan"], fused.frame_chunk(m, p))),
    }[what]()
    assert got == value


# -- the cell's reference ------------------------------------------------


def tiny_problem(seed=1):
    """A pool problem of the cell at ``tiny``'s size, on the CPU."""
    run = harness.Run(tiny.cell(CELL), torch.device("cpu"),
                      harness.load_program())
    run.make_problems([seed])
    return run.problems[0]


def test_the_cell_is_judged_by_the_restarting_reference():
    """Where every step is taken, ``cg_restart`` is ``cg`` bit for bit."""
    assert tiny.cell(CELL).reference is cg_restart
    p = tiny_problem()
    a, b = ref_cg.solve(p, 8), cg_restart.solve(p, 8)
    assert all(g > 0 for g in a.gamma)
    assert (a.residual, a.gamma) == (b.residual, b.gamma)
    assert torch.equal(a.psi, b.psi)


def test_a_rejected_step_restarts_the_reference(monkeypatch):
    """The third line search rejected, and object gradients that differ in
    their last bits each time they are evaluated (as ``index_add_``'s
    atomics make them on a card): ``cg_restart`` keeps the unmoved
    iterate's evaluation, so Dai-Yuan restarts at ``-g`` and the solve runs
    on; ``cg`` takes a denominator of rounding noise and stalls."""
    p = tiny_problem()
    real_evaluate = Ptycho.evaluate
    gen = torch.Generator().manual_seed(0)

    def noisy(self, psi, prb, data, model, want_psi=False, want_prb=False):
        f, gpsi, gprb = real_evaluate(self, psi, prb, data, model, want_psi,
                                      want_prb)
        if gpsi is not None:
            gpsi = gpsi * (1 + 1e-15 * torch.randn(
                gpsi.shape, generator=gen, dtype=torch.float64))
        return f, gpsi, gprb

    def reject_third(module):
        real, calls = module._backtrack, []

        def backtrack(f_of, f0, gamma0):
            calls.append(gamma0)
            return 0.0 if len(calls) == 3 else real(f_of, f0, gamma0)
        monkeypatch.setattr(module, "_backtrack", backtrack)

    monkeypatch.setattr(Ptycho, "evaluate", noisy)
    reject_third(cg_restart)
    reject_third(ref_cg)
    new, old = cg_restart.solve(p, 8), ref_cg.solve(p, 8)
    assert new.iters == 8 and new.gamma[2] == 0
    assert all(g > 0 for g in new.gamma[3:])
    assert new.residual[3] == new.residual[2] > new.residual[4]
    assert old.iters == 4 and old.gamma[2:] == [0.0, 0.0]


# -- the two span readers ------------------------------------------------

READERS = ("kernel.frame_pass.roofline.modes4",
           "kernel.tile_scatter.roofline.modes4")


def span_run(counts, device_s=2e-2):
    """A run at the configuration's sizes whose span report another reader
    has already made: ``counts`` spans of each name, ``device_s`` each."""
    geometry = Geometry(**{k: CONFIG[k] for k in (
        "nz", "n", "nscan", "ndet", "nprb", "ntheta", "nmodes")})
    meta = torch.device("meta")
    rep = types.SimpleNamespace(by_name={
        name: profiling.Figures(count=count, device_s=device_s)
        for name, count in counts.items()})
    return types.SimpleNamespace(
        geometry=geometry, program=harness.load_program(), span_report=rep,
        on_card=True, note=lambda line: None,
        problems=[types.SimpleNamespace(
            psi0=torch.empty((1, 512, 512), dtype=torch.complex64,
                             device=meta),
            prb0=torch.empty((1, 4, 128, 128), dtype=torch.complex64,
                             device=meta))])


def test_the_frames_follow_from_the_span_count():
    """16 chunk spans a pass of 16,384 positions x 4 modes; a count that is
    not whole passes gives nothing."""
    run = span_run({})
    assert frame_spans.frames(run, 16) == 16384 * 4
    assert frame_spans.frames(run, 48) == 3 * 16384 * 4
    assert frame_spans.frames(run, 17) is None


@pytest.mark.parametrize("order", [READERS, READERS[::-1]])
def test_the_span_readers_read_whatever_their_order(order):
    """Each reader's share from a report made before either ran: the same
    number in either order, each its stage's least time over its
    ``device_s``; None where the program has no such spans."""
    run = span_run({name: 32 for name in SPANS})
    got = {name: spec.load_module(
        ROOT / "h100bench" / "metrics" / f"{name}.py",
        f"h100bench.metrics.{name}").read(run) for name in order}
    frames = 2 * 16384 * 4
    obj, prb = 512 * 512 * 8, 4 * 128 * 128 * 8
    crops = frames * 128 * 128 * 8
    want = {
        READERS[0]: roofline.bound(
            roofline.fft_flops(frames, 1, 128, 2),
            frames // 4 * 128 * 128 * 4 + crops + 32 * (obj + prb))[0],
        READERS[1]: roofline.bound(0.0, crops + 32 * (obj + prb))[0],
    }
    for name in READERS:
        assert got[name] == pytest.approx(100 * want[name] / 20.0)
        assert 0 < got[name] <= 100
    bare = span_run({"cg.grad_pass": 32})
    assert all(spec.load_module(
        ROOT / "h100bench" / "metrics" / f"{name}.py",
        f"h100bench.metrics.{name}").read(bare) is None for name in READERS)


# -- the chunk path on the CPU ------------------------------------------

GEOM = Geometry(nz=48, n=40, nscan=37, ndet=16, nprb=12, ntheta=2,
                nmodes=4)


def problem(device="cpu"):
    """A 4-mode problem and a start (ones) far from its object, so that
    the gradient is O(1)."""
    gen = torch.Generator(device=device).manual_seed(3)
    _, scan, prb, data = make_problem(gen, GEOM, device=device)
    psi = torch.ones((GEOM.ntheta, GEOM.nz, GEOM.n), dtype=torch.complex64,
                     device=device)
    return psi, data, scan_to_int(scan), prb


def reference_grad(psi, data, scan_int, prb):
    """The plain reference's object gradient in complex128."""
    op = Ptycho(scan_int.double(), GEOM.nz, GEOM.n, GEOM.nprb, GEOM.ndet,
                "fp64", block=16)
    _, grad, _ = op.evaluate(psi.to(torch.complex128),
                             prb.to(torch.complex128), data, "gaussian",
                             want_psi=True)
    return grad


def _complex_at(address, count):
    """``count`` complex64 at a CPU ``address``: the scratch
    ``_scan_order`` hands a launch as a pointer."""
    buf = (ctypes.c_char * (8 * count)).from_address(address)
    return torch.frombuffer(buf, dtype=torch.complex64)


def plain_frame_pass(psi, data, scan_int, prb):
    """A stand-in for the frame kernel: the crops of the inverse frames of
    the likelihood residual, frames [g0, g1) into the scratch."""
    m, p = prb.shape[1], prb.shape[-1]
    resid = likelihoods.get_model("gaussian")[1]
    far = diffraction.fwd_raw(psi, scan_int, prb, GEOM.ndet, kernel="xla")
    crops = crop_from_det(ifft2o(resid(far, data)), p).reshape(-1, m * p * p)

    def launch(g0, g1, first, last, near, carry):
        _complex_at(near, (g1 - g0) * m * p * p).copy_(
            crops[g0:g1].reshape(-1))

    return launch


def plain_tile_scatter(frames, scan_int, prb, nz, n, out=None, partial=None,
                       from_partial=False, last=True, boxes=None, first=0):
    """A stand-in for the tile kernel: each position's modes times the
    conj probe, summed, added into the object in scan order in double,
    continuing from and leaving running sums as the kernel does."""
    k, c, _, p, _ = frames.shape
    acc = (partial.clone() if from_partial else
           torch.zeros((k, nz, n), dtype=torch.complex128))
    patches = torch.sum(frames.to(torch.complex128)
                        * prb.conj().to(torch.complex128)[:, None], dim=2)
    for th in range(k):
        for j in range(c):
            y, x = scan_int[th, j].tolist()
            acc[th, y:y + p, x:x + p] += patches[th, j]
    if not last:
        return partial.copy_(acc)
    return out.copy_(acc.to(torch.complex64))


def chunked(chunk, inputs):
    psi, data, scan_int, prb = inputs
    t, s = GEOM.ntheta, GEOM.nscan
    return fused._scan_order(fused.grad_fused,
                             plain_frame_pass(psi, data, scan_int, prb),
                             prb, scan_int, t, s, GEOM.nz, GEOM.n, chunk, 1,
                             1, torch.device("cpu"))


@pytest.fixture(scope="module")
def whole():
    """The problem, and its gradient on the chunk path in one chunk."""
    inputs = problem()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "_scatter_conj_probe_cuda", plain_tile_scatter)
        grad = chunked(GEOM.ntheta * GEOM.nscan, inputs)
    return inputs, grad


# 5, 7 and 30 frames split both angles of 37 positions; 37 does not; 40
# ends the first chunk three positions into the second angle.
@pytest.mark.parametrize("chunk", [5, 7, 30, 37, 40])
def test_chunks_that_split_angles_give_one_chunks_bits(whole, chunk,
                                                       monkeypatch):
    """The chunk path at 4 modes over chunks of ``chunk`` frames: the
    bits of one chunk, a frame pass and a tile scatter span a chunk, and
    the counter's frames x modes."""
    inputs, one = whole
    monkeypatch.setattr(kernels, "_scatter_conj_probe_cuda",
                        plain_tile_scatter)
    frames = GEOM.ntheta * GEOM.nscan
    before = fused.grad_fused.frames
    with span_report() as report:
        grad = chunked(chunk, inputs)
    assert torch.equal(grad, one)
    chunks = len(fused.frame_chunks(GEOM.ntheta, GEOM.nscan, chunk))
    assert chunks == -(-frames // chunk)
    for name in SPANS:
        assert report.by_name[name].count == chunks
    assert fused.grad_fused.frames - before == frames * GEOM.nmodes


def test_the_chunk_path_is_the_complex128_gradient(whole):
    inputs, one = whole
    ref = reference_grad(*inputs)
    err = float((one.to(torch.complex128) - ref).abs().max()
                / ref.abs().max())
    assert err < GRAD_RTOL, err


# -- on the card ------------------------------------------------------------

# The cell's frame and detector at two angles of 600 positions: the
# default chunk (1,024 frames) splits the second angle.
CARD = Geometry(nz=256, n=256, nscan=600, ndet=128, nprb=128, ntheta=2,
                nmodes=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def card_problem(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    _, scan, prb, data = make_problem(gen, CARD, device=dev)
    psi = torch.ones((CARD.ntheta, CARD.nz, CARD.n), dtype=torch.complex64,
                     device=dev)
    return psi, data, scan_to_int(scan), prb


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 7, 600, 777])
def test_card_gradient_over_chunks_is_one_chunks_bits(dev, chunk):
    """``grad_fused`` at 4 modes on the card: every launch on the
    shared-memory body, the same bits whatever the chunk, a frame pass and
    a tile scatter span a chunk, the counter's frames x modes, and the
    complex128 reference's gradient to ``GRAD_RTOL``."""
    psi, data, scan_int, prb = card_problem(dev)
    frames = CARD.ntheta * CARD.nscan
    one, f_one = fused._grad_fused_cuda(psi, data, scan_int, prb, CARD.ndet,
                                        "gaussian", None, chunk=frames)
    bodies = dict(fused.grad_fused.body_launches)
    before = fused.grad_fused.frames
    with span_report() as report:
        grad, f = fused._grad_fused_cuda(psi, data, scan_int, prb,
                                         CARD.ndet, "gaussian", None,
                                         chunk=chunk)
    chunks = len(fused.frame_chunks(
        CARD.ntheta, CARD.nscan, chunk or fused.frame_chunk(4, CARD.nprb)))
    assert chunks == (2 if chunk is None else -(-frames // chunk))
    assert torch.equal(grad, one) and float(f) == float(f_one)
    assert fused.grad_fused.body == "fft_smem"
    assert {k: v - bodies[k]
            for k, v in fused.grad_fused.body_launches.items()} == {
        "fft_regs": 0, "fft_smem": chunks, "gemm": 0, "atomic": 0}
    for name in SPANS:
        assert report.by_name[name].count == chunks
        assert report.by_name[name].device_s > 0
    assert fused.grad_fused.frames - before == frames * CARD.nmodes
    op = Ptycho(scan_int.double(), CARD.nz, CARD.n, CARD.nprb, CARD.ndet,
                "fp64", block=256)
    _, ref, _ = op.evaluate(psi.to(torch.complex128),
                            prb.to(torch.complex128), data, "gaussian",
                            want_psi=True)
    err = float((grad.to(torch.complex128) - ref).abs().max()
                / ref.abs().max())
    assert err < GRAD_RTOL, err
