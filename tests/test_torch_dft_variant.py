"""Which of their two hand-written kernels the eight DFT kernels --
``grad_fused``, ``minf_fused``, ``grad_prb_fused``, ``fwd``, ``adj``,
``adj_probe``, ``adj_residual`` and ``fwd_quad_stats`` -- launch on the card
is one pure function of the shapes (one, because a line search compares the
objectives of the first three, which must share their arithmetic, and
``fwd`` stores the farplane they read as a base), pinned here on the CPU:
``'fft'`` (the frame's FFT in shared memory) for a detector side of 16, 32,
64 or 128, ``'gemm'`` (DFT matrix products) for every other size.
``ls_objectives`` launches its frame-major kernel for every step count,
instantiated for the step bucket ``linesearch.step_bucket`` names. The
choice is made before the launch and never changed after it; on a CPU
tensor no kernel runs (the plain version does)."""

import inspect

import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from tikejax_torch import Geometry
from tikejax_torch.models import make_problem
from tikejax_torch.ops import fused, kernels, linesearch
from tikejax_torch.ops.patches import scan_to_int


@pytest.mark.parametrize("nprb, ndet, nmodes", [
    (128, 128, 1), (64, 128, 2), (128, 128, 4), (48, 64, 2), (16, 16, 1),
    (20, 32, 3)])
def test_power_of_two_sides_take_the_fft_kernel(nprb, ndet, nmodes):
    assert fused.dft_variant(nprb, ndet, nmodes) == "fft"


@pytest.mark.parametrize("nprb, ndet, nmodes", [
    (56, 72, 2), (100, 130, 1), (128, 256, 1), (8, 8, 1), (48, 48, 3),
    (256, 512, 1)])
def test_other_sides_take_the_gemm_kernel(nprb, ndet, nmodes):
    assert fused.dft_variant(nprb, ndet, nmodes) == "gemm"


@pytest.mark.parametrize("nprb, ndet, nmodes", [
    (129, 128, 1), (64, 32, 2), (64, 4096, 1), (16, 16, 0)])
def test_sizes_no_kernel_takes_raise(nprb, ndet, nmodes):
    with pytest.raises(ValueError, match="nprb <= ndet|nmodes"):
        fused.dft_variant(nprb, ndet, nmodes)


def test_forced_variant_is_checked_before_any_launch():
    """The private CUDA wrappers take ``variant``: None follows the
    shapes, 'gemm' runs every size, 'fft' only its own, anything else
    raises -- all decided from the shapes, with no device in play."""
    pick = fused._pick_variant
    assert pick("grad_fused", None, 128, 128, 1) == "fft"
    assert pick("grad_fused", "gemm", 128, 128, 1) == "gemm"
    assert pick("adj_probe", None, 56, 72, 2) == "gemm"
    assert pick("adj_probe", "fft", 48, 64, 2) == "fft"
    with pytest.raises(ValueError, match="'fft' variant takes ndet"):
        fused._pick_variant("adj_probe", "fft", 56, 72, 2)
    for bad in ("fast", "fft_unpadded", "pixel"):
        with pytest.raises(ValueError, match="unknown variant"):
            fused._pick_variant("grad_fused", bad, 128, 128, 1)
    with pytest.raises(ValueError, match="grad_fused: need nprb <= ndet"):
        fused._pick_variant("grad_fused", None, 130, 128, 1)
    for fn in (fused._grad_fused_cuda, fused._minf_fused_cuda,
               fused._grad_prb_fused_cuda, fused._adj_probe_cuda,
               fused._fwd_cuda, fused._adj_cuda, fused._adj_residual_cuda,
               fused._fwd_quad_stats_cuda):
        params = inspect.signature(fn).parameters
        assert params["variant"].default is None
        assert "threads" not in params and "prefetch" not in params
    assert fused.fft_threads(128) == 1024 and fused.fft_threads(64) == 512


def test_public_signatures_are_the_reference_ones():
    """No public signature gained a variant argument."""
    assert list(inspect.signature(fused.grad_fused).parameters) == [
        "psi", "data", "scan_int", "prb", "ndet", "model", "precision",
        "adj_precision", "base"]
    assert list(inspect.signature(fused.adj_probe).parameters) == [
        "farplane", "scan_int", "psi", "nprb", "precision"]
    assert list(inspect.signature(fused.minf_fused).parameters) == [
        "psi", "data", "scan_int", "prb", "ndet", "model", "precision",
        "base"]
    assert list(inspect.signature(fused.grad_prb_fused).parameters) == [
        "psi", "data", "scan_int", "prb", "ndet", "model", "precision",
        "adj_precision"]
    assert list(inspect.signature(fused.fwd).parameters) == [
        "psi", "scan_int", "prb", "ndet", "precision", "base", "split_out"]
    assert list(inspect.signature(fused.adj_residual).parameters) == [
        "farplane", "data", "scan_int", "prb", "nz", "n", "model",
        "precision"]
    assert list(inspect.signature(fused.fwd_quad_stats).parameters) == [
        "dpsi", "scan_int", "prb", "fpsi", "precision"]
    assert list(inspect.signature(linesearch.ls_objectives).parameters) == [
        "fpsi", "fd", "data", "gammas", "model"]
    assert list(inspect.signature(fused.adj).parameters) == [
        "farplane", "scan_int", "prb", "nz", "n", "precision"]
    assert list(inspect.signature(kernels.gather_probe_mul).parameters) == [
        "psi", "scan_int", "prb"]


@pytest.mark.parametrize("ndet, nmodes, body", [
    (128, 1, "fft_regs"), (128, 2, "fft_smem"), (128, 4, "fft_smem"),
    (64, 1, "fft_smem"), (32, 3, "fft_smem"), (16, 1, "fft_smem")])
def test_grad_fused_body_is_a_function_of_the_shapes(ndet, nmodes, body):
    """Within the 'fft' variant grad_fused runs its fused body at 128 with
    one mode and the shared-memory body at every other FFT shape, whatever
    the probe's side."""
    assert fused.fft_body(ndet, nmodes) == body
    for nprb in (ndet, ndet - 4, 1):
        for variant in (None, "fft"):
            assert fused._pick_body("grad_fused", variant, nprb, ndet,
                                    nmodes) == ("fft", body)


@pytest.mark.parametrize("variant, expect", [
    ("fft_smem", ("fft", "fft_smem")),
    ("atomic", ("fft", "atomic")),
    ("gemm", ("gemm", "gemm"))])
def test_shared_memory_body_runs_at_128_only_when_forced(variant, expect):
    """At the shapes of the fused body the shared-memory one (and the
    atomic kernel, the 'gemm' variant) runs only when the caller forces it;
    'fft_smem' off the FFT sizes raises before any launch, as a forced
    'fft' does."""
    assert fused._pick_body("grad_fused", variant, 128, 128, 1) == expect
    assert fused._pick_body("grad_fused", None, 100, 130, 1) == ("gemm",
                                                                 "gemm")
    with pytest.raises(ValueError, match="'fft' variant takes ndet"):
        fused._pick_body("grad_fused",
                         variant if variant != "gemm" else "fft_smem", 56,
                         72, 1)
    assert set(fused.grad_fused.body_launches) == {
        "fft_regs", "fft_smem", "gemm", "atomic"}


@pytest.mark.parametrize("ndet, nmodes, body", [
    (128, 1, "fft_regs"), (128, 2, "fft_smem"), (128, 4, "fft_smem"),
    (64, 1, "fft_smem"), (32, 3, "fft_smem"), (16, 1, "fft_smem")])
def test_minf_fused_body_is_grad_fuseds(ndet, nmodes, body):
    """minf_fused picks its FFT body by the rule grad_fused's follows (the
    line search compares their objectives, which the two bodies keep equal
    bit for bit): the fused body at 128 with one mode, the shared-memory
    body at every other FFT shape, whatever the probe's side."""
    for nprb in (ndet, ndet - 4, 1):
        for variant in (None, "fft"):
            assert fused._pick_body("minf_fused", variant, nprb, ndet,
                                    nmodes) == ("fft", body)


@pytest.mark.parametrize("variant, expect", [
    (None, ("fft", "fft_regs")),
    ("fft", ("fft", "fft_regs")),
    ("fft_smem", ("fft", "fft_smem")),
    ("gemm", ("gemm", "gemm"))])
def test_minf_fused_shared_memory_body_runs_at_128_only_when_forced(
        variant, expect):
    """At 128^2 with one mode minf_fused runs its shared-memory body only
    when the caller forces it, and 'gemm' only when forced; off the FFT
    sizes 'gemm' runs and a forced 'fft_smem' raises before any launch.
    grad_fused's one-pass atomic kernel has no minf_fused counterpart. Each
    launch counts in one of the three bodies."""
    assert fused._pick_body("minf_fused", variant, 128, 128, 1) == expect
    assert fused._pick_body("minf_fused", None, 100, 130, 1) == ("gemm",
                                                                 "gemm")
    with pytest.raises(ValueError, match="minf_fused: the 'fft' variant"):
        fused._pick_body("minf_fused", "fft_smem", 56, 72, 1)
    with pytest.raises(ValueError, match="unknown variant 'atomic'"):
        fused._pick_body("minf_fused", "atomic", 128, 128, 1)
    assert set(fused.minf_fused.body_launches) == {
        "fft_regs", "fft_smem", "gemm"}


def test_minf_fused_on_cpu_counts_no_body():
    """On CPU tensors at the fused body's shapes minf_fused runs its plain
    version: no launch, no body recorded, no body counted."""
    g = Geometry(nz=140, n=140, nscan=3, ndet=128, nprb=16)
    assert fused.fft_body(g.ndet, g.nmodes) == "fft_regs"
    gen = torch.Generator().manual_seed(4)
    _, scan, prb, data = make_problem(gen, g, device="cpu")
    psi = torch.ones(g.psi_shape, dtype=torch.complex64)
    before = (dict(fused.minf_fused.body_launches), fused.minf_fused.body,
              fused.minf_fused.launches,
              fused.minf_fused_reference.launches)
    minf = fused.minf_fused(psi, data, scan_to_int(scan), prb, g.ndet,
                            "poisson")
    assert bool(torch.isfinite(minf))
    assert (dict(fused.minf_fused.body_launches), fused.minf_fused.body,
            fused.minf_fused.launches,
            fused.minf_fused_reference.launches) == before[:3] + (
        before[3] + 1,)


@pytest.mark.parametrize("name", ["fwd", "adj_residual", "fwd_quad_stats",
                                  "adj"])
def test_fwd_and_adj_residual_pick_as_the_others(name):
    """``fwd``, ``adj_residual``, ``fwd_quad_stats`` and ``adj`` follow the
    same rule: 'fft' at the
    power-of-two sides, 'gemm' elsewhere, a forced 'fft' off those sides
    raising before any launch."""
    pick = fused._pick_variant
    assert pick(name, None, 128, 128, 1) == "fft"
    assert pick(name, None, 48, 64, 4) == "fft"
    assert pick(name, None, 56, 72, 2) == "gemm"
    assert pick(name, "gemm", 128, 128, 1) == "gemm"
    assert pick(name, "fft", 20, 32, 3) == "fft"
    with pytest.raises(ValueError, match=f"{name}: the 'fft' variant"):
        pick(name, "fft", 100, 130, 1)
    with pytest.raises(ValueError, match=f"{name}: need nprb <= ndet"):
        pick(name, None, 130, 128, 1)


@pytest.mark.parametrize("k, bucket", [
    (1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 17), (17, 17),
    (18, 33), (33, 33)])
def test_step_bucket_is_the_smallest_that_holds_k(k, bucket):
    assert linesearch.step_bucket(k) == bucket


def test_step_bucket_covers_every_step_count_and_raises_outside():
    """Every K from 1 to 33 has a frame-major instantiation, the least of
    the buckets that is >= K; no other K has one."""
    for k in range(1, linesearch.MAX_STEPS + 1):
        bucket = linesearch.step_bucket(k)
        assert bucket in linesearch.STEP_BUCKETS and bucket >= k
        assert all(b < k for b in linesearch.STEP_BUCKETS if b < bucket)
    for k in (0, -1, 34, 100):
        with pytest.raises(ValueError, match="1 to 33 steps"):
            linesearch.step_bucket(k)


def test_adj_and_gather_on_cpu_run_the_plain_version():
    """``fused.adj`` at an FFT size and ``kernels.gather_probe_mul`` on CPU
    tensors: the plain versions run, no kernel launches and no variant is
    recorded, and the wrappers return what the plain versions return."""
    g = Geometry(nz=40, n=40, nscan=6, ndet=32, nprb=16, nmodes=2)
    assert fused.dft_variant(g.nprb, g.ndet, g.nmodes) == "fft"
    gen = torch.Generator().manual_seed(3)
    _, scan, prb, _ = make_problem(gen, g, device="cpu")
    scan_i = scan_to_int(scan)
    psi = torch.complex(torch.randn(g.psi_shape, generator=gen),
                        torch.randn(g.psi_shape, generator=gen))
    far = fused.fwd(psi, scan_i, prb, g.ndet)
    fns = (fused.adj, kernels.gather_probe_mul, fused.adj_reference,
           kernels.gather_probe_mul_reference)
    before = [fn.launches for fn in fns]
    variant = fused.adj.variant
    obj = fused.adj(far, scan_i, prb, g.nz, g.n)
    near = kernels.gather_probe_mul(psi, scan_i, prb)
    assert obj.shape == g.psi_shape
    assert near.shape == (g.ntheta, g.nscan, g.nmodes, g.nprb, g.nprb)
    assert torch.equal(obj, fused.adj_reference(far, scan_i, prb, g.nz, g.n))
    assert torch.equal(near, kernels.gather_probe_mul_reference(psi, scan_i,
                                                                prb))
    assert [fn.launches - b for fn, b in zip(fns, before)] == [0, 0, 2, 2]
    assert fused.adj.variant == variant


def test_cpu_tensors_run_the_plain_version_at_fft_sizes():
    """At a size whose CUDA kernel would be the FFT one, a CPU tensor still
    runs the plain version and launches nothing."""
    g = Geometry(nz=40, n=40, nscan=6, ndet=32, nprb=16, nmodes=2)
    assert fused.dft_variant(g.nprb, g.ndet, g.nmodes) == "fft"
    gen = torch.Generator().manual_seed(0)
    _, scan, prb, data = make_problem(gen, g, device="cpu")
    psi = torch.ones(g.psi_shape, dtype=torch.complex64)
    counts = (fused.grad_fused.launches, fused.adj_probe.launches,
              fused.grad_fused_reference.launches,
              fused.adj_probe_reference.launches)
    grad, minf = fused.grad_fused(psi, data, scan_to_int(scan), prb, g.ndet,
                                  "gaussian")
    far = fused.fwd(psi, scan_to_int(scan), prb, g.ndet)
    probe = fused.adj_probe(far, scan_to_int(scan), psi, g.nprb)
    assert grad.shape == g.psi_shape and probe.shape == g.prb_shape
    assert bool(torch.isfinite(minf))
    assert (fused.grad_fused.launches, fused.adj_probe.launches,
            fused.grad_fused_reference.launches,
            fused.adj_probe_reference.launches) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)


def test_fwd_and_adj_residual_on_cpu_run_the_plain_version():
    """``fwd`` (with and without a base, and split) and ``adj_residual`` on
    CPU tensors at an FFT size: the plain versions run, no kernel launches,
    and the wrappers return what the plain versions return."""
    g = Geometry(nz=40, n=40, nscan=6, ndet=32, nprb=16, nmodes=2)
    assert fused.dft_variant(g.nprb, g.ndet, g.nmodes) == "fft"
    gen = torch.Generator().manual_seed(1)
    _, scan, prb, data = make_problem(gen, g, device="cpu")
    scan_i = scan_to_int(scan)
    psi = torch.ones(g.psi_shape, dtype=torch.complex64)
    fns = (fused.fwd, fused.adj_residual, fused.fwd_reference,
           fused.adj_residual_reference)
    before = [fn.launches for fn in fns]
    far = fused.fwd(psi, scan_i, prb, g.ndet)
    based = fused.fwd(psi, scan_i, prb, g.ndet, base=far)
    re, im = fused.fwd(psi, scan_i, prb, g.ndet, base=far, split_out=True)
    grad, minf = fused.adj_residual(far, data, scan_i, prb, g.nz, g.n,
                                    "poisson")
    assert far.shape == g.farplane_shape and grad.shape == g.psi_shape
    assert torch.equal(based, 2 * far)
    assert torch.equal(torch.complex(re, im), based)
    ref_grad, ref_minf = fused.adj_residual_reference(
        far, data, scan_i, prb, g.nz, g.n, "poisson")
    assert torch.equal(grad, ref_grad) and float(minf) == float(ref_minf)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [0, 0, 3, 2]


def test_fwd_quad_stats_and_ls_objectives_on_cpu_run_the_plain_version():
    """``fwd_quad_stats`` and ``ls_objectives`` on CPU tensors at an FFT
    size: the plain versions run, no kernel launches and no variant is
    recorded, and the wrappers return what the plain versions return."""
    g = Geometry(nz=40, n=40, nscan=6, ndet=32, nprb=16, nmodes=2)
    assert fused.dft_variant(g.nprb, g.ndet, g.nmodes) == "fft"
    gen = torch.Generator().manual_seed(2)
    _, scan, prb, data = make_problem(gen, g, device="cpu")
    scan_i = scan_to_int(scan)
    psi = torch.ones(g.psi_shape, dtype=torch.complex64)
    far = fused.fwd(psi, scan_i, prb, g.ndet)
    fns = (fused.fwd_quad_stats, linesearch.ls_objectives,
           fused.fwd_quad_stats_reference,
           linesearch.ls_objectives_reference)
    before = [fn.launches for fn in fns]
    variant = fused.fwd_quad_stats.variant
    stats = fused.fwd_quad_stats(0.5 * psi, scan_i, prb, far)
    values = linesearch.ls_objectives(far, 0.5 * far, data, [1.0, 0.5, 0.25],
                                      "poisson")
    assert all(x.shape == g.data_shape for x in stats)
    assert values.shape == (3,)
    ref = fused.fwd_quad_stats_reference(0.5 * psi, scan_i, prb, far)
    assert all(torch.equal(x, r) for x, r in zip(stats, ref))
    assert torch.equal(values, linesearch.ls_objectives_reference(
        far, 0.5 * far, data, [1.0, 0.5, 0.25], "poisson"))
    assert [fn.launches - b for fn, b in zip(fns, before)] == [0, 0, 2, 2]
    assert fused.fwd_quad_stats.variant == variant
