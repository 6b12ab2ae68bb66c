"""The CUDA kernels ``grad_fused`` (with and without a base), ``fwd``,
``minf_fused``, ``grad_prb_fused``, ``adj``, ``adj_probe``,
``adj_residual``, ``fwd_quad_stats``, ``ls_objectives`` and the hybrid
tier's ``gather_probe_mul``, ``scatter_conj_probe`` and
``adj_probe_reduce`` against their plain PyTorch versions, on the card.
Marked ``cuda``: without a CUDA device every test here skips. On a machine
with a card (the JAX package need not be installed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the JAX package's fused parity bound for the gradients, the
adjoints and the farplane (1e-4 of their scale) and 1e-5 relative for the
objective -- both sides are fp32 and sum in different orders; the hybrid
tier's kernels have no DFT in them and are held to 1e-5 of scale. The probe
reductions (``grad_prb_fused``, ``adj_probe``, ``adj_probe_reduce``),
``gather_probe_mul``, ``scatter_conj_probe`` (its tile kernel: each pixel
sums its positions in scan order), ``fwd_quad_stats`` and
``ls_objectives`` are bitwise reproducible, and so are the fused object
scatters of ``adj``, ``grad_fused`` and ``adj_residual`` (their frames,
summed chunk by chunk by the tile kernel in scan order, the same bits
whatever the chunk; within 1e-5 of scale of the forced one-pass atomic
kernels they replaced, whose objectives they keep bit for bit). The
``'fft'`` operators are also held against a complex128 oracle on the card,
at the reference's ``fused_hp`` operator bound (~4e-7).

``grad_fused``, ``minf_fused``, ``grad_prb_fused``, ``fwd``, ``adj``,
``adj_probe``, ``adj_residual`` and ``fwd_quad_stats`` have two kernels
each: ``GEOMS`` runs their ``'gemm'`` variant (but for its 32^2 detector),
``POW2_GEOMS`` their ``'fft'`` variant, and one shape runs both, forced
through the private wrappers' ``variant`` argument (``ADJ_GEOMS`` both of
``adj``'s). On ``'fft'`` the
farplane ``fwd`` stores is bit for bit the one ``minf_fused`` forms inside,
``fwd_quad_stats`` of a direction on its own farplane gives
``a == b == c`` bit for bit, and ``fwd`` and ``adj`` are a pair to 1e-5.
``ls_objectives`` launches its frame-major kernel; the pixel-major one,
forced, is held to the same values. ``gather_probe_mul`` launches its
persistent kernel; the pixel kernel it replaced, forced, writes the same
bits. ``scatter_conj_probe`` launches its tile kernel; the atomic kernel it
replaced, forced, is held to the same values within 1e-5 of scale, and the
tile kernel writes the same bits whatever the frames' strides, and with or
without its chunk skip.
"""

import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from tikejax_torch import Geometry  # noqa: E402
from tikejax_torch.models import make_problem  # noqa: E402
from tikejax_torch.ops import diffraction, fused, kernels, linesearch  # noqa: E402,E501
from tikejax_torch.ops.patches import scan_to_int  # noqa: E402

pytestmark = pytest.mark.cuda

GEOMS = [
    Geometry(nz=97, n=101, nscan=37, ndet=72, nprb=56, ntheta=2, nmodes=2),
    Geometry(nz=64, n=64, nscan=9, ndet=32, nprb=20),           # nprb % 8
    Geometry(nz=70, n=66, nscan=20, ndet=48, nprb=48, nmodes=3),
    Geometry(nz=200, n=180, nscan=50, ndet=130, nprb=100),      # > 2 tiles
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def inputs(g, dev, seed=0):
    """Kernel inputs on the card; the last angle's third position is a
    masked dummy, and psi is random so the gradient is O(1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    scan_i = scan_to_int(scan)
    scan_i[-1, min(2, g.nscan - 1), 0] = -1
    psi = torch.complex(torch.randn(g.psi_shape, generator=gen, device=dev),
                        torch.randn(g.psi_shape, generator=gen, device=dev))
    return psi, data, scan_i, prb


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_kernel_matches_plain_version(dev, g, model):
    args = inputs(g, dev)
    launches = fused.grad_fused.launches
    g_k, f_k = fused.grad_fused(*args, g.ndet, model)
    g_r, f_r = fused.grad_fused_reference(*args, g.ndet, model)
    assert fused.grad_fused.launches == launches + 1
    assert g_k.dtype == torch.complex64 and g_k.shape == g.psi_shape
    scale = float(g_r.abs().max())
    assert float((g_k - g_r).abs().max()) <= 1e-4 * scale
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))


def test_objective_is_bitwise_reproducible(dev):
    g = GEOMS[0]
    args = inputs(g, dev)
    values = {float(fused.grad_fused(*args, g.ndet, "gaussian")[1])
              for _ in range(3)}
    assert len(values) == 1


def test_masked_positions_contribute_nothing(dev):
    """All positions masked: zero gradient and zero objective."""
    g = GEOMS[1]
    psi, data, scan_i, prb = inputs(g, dev)
    scan_i[..., 0] = -1
    grad, minf = fused.grad_fused(psi, data, scan_i, prb, g.ndet, "gaussian")
    assert float(grad.abs().max()) == 0.0 and float(minf) == 0.0


def test_wrong_inputs_raise(dev):
    g = GEOMS[1]
    psi, data, scan_i, prb = inputs(g, dev)
    with pytest.raises(TypeError, match="complex64"):
        fused.grad_fused(psi.to(torch.complex128), data, scan_i,
                         prb.to(torch.complex128), g.ndet, "gaussian")
    with pytest.raises(ValueError, match="is on"):
        fused.grad_fused(psi, data.cpu(), scan_i, prb, g.ndet, "gaussian")
    with pytest.raises(ValueError, match="shapes"):
        fused.grad_fused(psi, data, scan_i, prb, g.ndet + 2, "gaussian")


def base_for(g, dev, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.complex(torch.randn(g.farplane_shape, generator=gen,
                                     device=dev),
                         torch.randn(g.farplane_shape, generator=gen,
                                     device=dev))


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_grad_fused_base_matches_plain_version(dev, g, model):
    args = inputs(g, dev)
    base = base_for(g, dev)
    launches = fused.grad_fused.launches
    g_k, f_k = fused.grad_fused(*args, g.ndet, model, base=base)
    g_s, f_s = fused.grad_fused(*args, g.ndet, model,
                                base=torch.view_as_real(base).unbind(-1))
    g_r, f_r = fused.grad_fused_reference(*args, g.ndet, model, base=base)
    assert fused.grad_fused.launches == launches + 2
    scale = float(g_r.abs().max())
    assert float((g_k - g_r).abs().max()) <= 1e-4 * scale
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))
    assert float(f_s) == float(f_k)  # the split views are the same base


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_fwd_matches_plain_version(dev, g, with_base):
    psi, _, scan_i, prb = inputs(g, dev)
    base = base_for(g, dev) if with_base else None
    launches = fused.fwd.launches
    out = fused.fwd(psi, scan_i, prb, g.ndet, base=base)
    re, im = fused.fwd(psi, scan_i, prb, g.ndet, base=base, split_out=True)
    ref = fused.fwd_reference(psi, scan_i, prb, g.ndet, base=base)
    assert fused.fwd.launches == launches + 2
    assert out.dtype == torch.complex64 and out.shape == g.farplane_shape
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(torch.complex(re, im), out)
    masked = scan_i[..., 0] < 0
    expect = base[masked] if with_base else torch.zeros_like(out[masked])
    assert torch.equal(out[masked], expect)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_minf_fused_matches_plain_version(dev, g, model, with_base):
    psi, data, scan_i, prb = inputs(g, dev)
    base = base_for(g, dev) if with_base else None
    launches = fused.minf_fused.launches
    f_k = fused.minf_fused(psi, data, scan_i, prb, g.ndet, model, base=base)
    f_r = fused.minf_fused_reference(psi, data, scan_i, prb, g.ndet, model,
                                     base=base)
    assert fused.minf_fused.launches == launches + 1
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))
    again = fused.minf_fused(psi, data, scan_i, prb, g.ndet, model, base=base)
    assert float(again) == float(f_k)  # bitwise reproducible


def test_base_in_wrong_form_raises(dev):
    g = GEOMS[1]
    psi, data, scan_i, prb = inputs(g, dev)
    base = base_for(g, dev)
    with pytest.raises(ValueError, match="base"):
        fused.minf_fused(psi, data, scan_i, prb, g.ndet, "gaussian",
                         base=base[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        fused.fwd(psi, scan_i, prb, g.ndet,
                  base=base.transpose(-1, -2))
    with pytest.raises(ValueError, match="complex64"):
        fused.fwd(psi, scan_i, prb, g.ndet, base=base.to(torch.complex128))
    with pytest.raises(ValueError, match="view_as_real"):
        fused.grad_fused(psi, data, scan_i, prb, g.ndet, "gaussian",
                         base=(base.real.clone(), base.imag.clone()))


def close(got, ref, tol=1e-4):
    return float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_grad_prb_fused_matches_plain_version(dev, g, model):
    args = inputs(g, dev)
    launches = fused.grad_prb_fused.launches
    g_k, f_k = fused.grad_prb_fused(*args, g.ndet, model)
    g_r, f_r = fused.grad_prb_fused_reference(*args, g.ndet, model)
    assert fused.grad_prb_fused.launches == launches + 1
    assert g_k.dtype == torch.complex64 and g_k.shape == g.prb_shape
    assert close(g_k, g_r)
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))


@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_adjoints_match_plain_versions(dev, g):
    psi, _, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    a0, p0 = fused.adj.launches, fused.adj_probe.launches
    a_k = fused.adj(far, scan_i, prb, g.nz, g.n)
    p_k = fused.adj_probe(far, scan_i, psi, g.nprb)
    assert (fused.adj.launches, fused.adj_probe.launches) == (a0 + 1, p0 + 1)
    assert a_k.shape == g.psi_shape and p_k.shape == g.prb_shape
    assert close(a_k, fused.adj_reference(far, scan_i, prb, g.nz, g.n))
    assert close(p_k, fused.adj_probe_reference(far, scan_i, psi, g.nprb))


def test_probe_reductions_are_bitwise_reproducible(dev):
    g = GEOMS[0]
    psi, data, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    grads = [fused.grad_prb_fused(psi, data, scan_i, prb, g.ndet,
                                  "gaussian") for _ in range(3)]
    probes = [fused.adj_probe(far, scan_i, psi, g.nprb) for _ in range(3)]
    assert all(torch.equal(x[0], grads[0][0]) for x in grads)
    assert len({float(x[1]) for x in grads}) == 1
    assert all(torch.equal(x, probes[0]) for x in probes)


def test_new_kernels_skip_masked_positions(dev):
    """All positions masked: zero probe gradient, objective and adjoints."""
    g = GEOMS[1]
    psi, data, scan_i, prb = inputs(g, dev)
    scan_i[..., 0] = -1
    far = base_for(g, dev)
    grad, minf = fused.grad_prb_fused(psi, data, scan_i, prb, g.ndet,
                                      "poisson")
    assert float(grad.abs().max()) == 0.0 and float(minf) == 0.0
    assert float(fused.adj(far, scan_i, prb, g.nz, g.n).abs().max()) == 0.0
    assert float(fused.adj_probe(far, scan_i, psi, g.nprb).abs().max()) == 0


def test_fused_operators_launch_the_kernels(dev):
    """On a fused tier the operator-level adjoints (and fwd's autograd)
    run the kernels."""
    g = GEOMS[2]
    psi, _, scan_i, prb = inputs(g, dev)
    counts = [fused.fwd.launches, fused.adj.launches,
              fused.adj_probe.launches]
    psi_g = psi.clone().requires_grad_()
    prb_g = prb.clone().requires_grad_()
    far = diffraction.fwd(psi_g, scan_i, prb_g, g.ndet, "fused_hp")
    (far.abs()**2).sum().backward()
    assert [fused.fwd.launches, fused.adj.launches,
            fused.adj_probe.launches] == [c + 1 for c in counts]
    ref = diffraction.fwd_raw(psi, scan_i, prb, g.ndet, "xla")
    assert close(psi_g.grad, diffraction.adj_raw(2 * ref, scan_i, prb, g.nz,
                                                 g.n, "xla"))
    assert close(prb_g.grad, diffraction.adj_probe_raw(2 * ref, scan_i, psi,
                                                       g.nprb, "xla"))


# -- the hybrid tier's kernels: gather_probe_mul, scatter_conj_probe,
# adj_probe_reduce ------------------------------------------------------------


def cropped_frames(g, dev):
    """(t, s, m, nprb, nprb) frames as the adjoint operators hand them
    over: the top-left crop of ndet^2 frames, strided when ndet > nprb."""
    return base_for(g, dev)[..., :g.nprb, :g.nprb]


@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_gather_probe_mul_matches_plain_version(dev, g):
    psi, _, scan_i, prb = inputs(g, dev)
    launches = kernels.gather_probe_mul.launches
    got = kernels.gather_probe_mul(psi, scan_i, prb)
    ref = kernels.gather_probe_mul_reference(psi, scan_i, prb)
    assert kernels.gather_probe_mul.launches == launches + 1
    assert got.dtype == torch.complex64
    assert got.shape == (g.ntheta, g.nscan, g.nmodes, g.nprb, g.nprb)
    assert close(got, ref, 1e-5)
    masked = scan_i[..., 0] < 0
    assert float(got[masked].abs().max()) == 0.0
    assert torch.equal(got, kernels.gather_probe_mul(psi, scan_i, prb))


@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_hybrid_adjoints_match_plain_versions(dev, g):
    """scatter_conj_probe and adj_probe_reduce on a strided crop and on its
    contiguous copy; both bitwise repeatable (the scatter on its tile
    kernel)."""
    psi, _, scan_i, prb = inputs(g, dev)
    near = cropped_frames(g, dev)
    assert near.is_contiguous() == (g.ndet == g.nprb)
    s0, p0 = (kernels.scatter_conj_probe.launches,
              kernels.adj_probe_reduce.launches)
    for frames in (near, near.contiguous()):
        a_k = kernels.scatter_conj_probe(frames, scan_i, prb, g.nz, g.n)
        p_k = kernels.adj_probe_reduce(frames, scan_i, psi)
        assert a_k.shape == g.psi_shape and p_k.shape == g.prb_shape
        assert a_k.dtype == p_k.dtype == torch.complex64
        assert close(a_k, kernels.scatter_conj_probe_reference(
            frames, scan_i, prb, g.nz, g.n), 1e-5)
        assert close(p_k, kernels.adj_probe_reduce_reference(
            frames, scan_i, psi), 1e-5)
        assert torch.equal(p_k, kernels.adj_probe_reduce(frames, scan_i, psi))
        assert kernels.scatter_conj_probe.variant == "tile"
        assert torch.equal(kernels.scatter_conj_probe(frames, scan_i, prb,
                                                      g.nz, g.n), a_k)
    assert kernels.scatter_conj_probe.launches == s0 + 4
    assert kernels.adj_probe_reduce.launches == p0 + 4


def test_hybrid_kernels_skip_masked_positions(dev):
    """All positions masked: zero frames and zero adjoints, whatever the
    frames hold."""
    g = GEOMS[0]
    psi, _, scan_i, prb = inputs(g, dev)
    scan_i[..., 0] = -1
    near = cropped_frames(g, dev)
    assert float(kernels.gather_probe_mul(psi, scan_i, prb).abs().max()) == 0
    assert float(kernels.scatter_conj_probe(near, scan_i, prb, g.nz,
                                            g.n).abs().max()) == 0.0
    assert float(kernels.adj_probe_reduce(near, scan_i, psi).abs().max()) == 0


def test_hybrid_kernels_wrong_inputs_raise(dev):
    """A CUDA tensor launches the kernel or raises: no other type, no
    tensor on another device, no frames whose innermost stride is not 1."""
    g = GEOMS[1]
    psi, _, scan_i, prb = inputs(g, dev)
    near = cropped_frames(g, dev)
    with pytest.raises(TypeError, match="complex64"):
        kernels.gather_probe_mul(psi.to(torch.complex128), scan_i,
                                 prb.to(torch.complex128))
    with pytest.raises(TypeError, match="int32"):
        kernels.gather_probe_mul(psi, scan_i.long(), prb)
    with pytest.raises(ValueError, match="is on"):
        kernels.scatter_conj_probe(near, scan_i.cpu(), prb, g.nz, g.n)
    with pytest.raises(ValueError, match="shapes"):
        kernels.adj_probe_reduce(near, scan_i[:, :-1], psi)
    with pytest.raises(ValueError, match="innermost stride"):
        kernels.scatter_conj_probe(near.transpose(-1, -2), scan_i, prb, g.nz,
                                   g.n)
    with pytest.raises(TypeError, match="complex64"):
        kernels.adj_probe_reduce(near.to(torch.complex128), scan_i, psi)


def test_pallas_operators_launch_the_kernels(dev):
    """On the hybrid tier the operators and fwd's autograd run the three
    kernels (the adjoints on the strided crop of the inverse FFT) and no
    plain version; values as the oracle's."""
    g = GEOMS[0]
    psi, _, scan_i, prb = inputs(g, dev)
    fns = [kernels.gather_probe_mul, kernels.scatter_conj_probe,
           kernels.adj_probe_reduce]
    plain = [kernels.gather_probe_mul_reference,
             kernels.scatter_conj_probe_reference,
             kernels.adj_probe_reduce_reference]
    counts, p_counts = [f.launches for f in fns], [f.launches for f in plain]
    psi_g = psi.clone().requires_grad_()
    prb_g = prb.clone().requires_grad_()
    far = diffraction.fwd(psi_g, scan_i, prb_g, g.ndet, "pallas")
    (far.abs()**2).sum().backward()
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    assert [f.launches for f in plain] == p_counts
    ref = diffraction.fwd_raw(psi, scan_i, prb, g.ndet, "xla")
    assert close(far.detach(), ref, 1e-5)
    assert close(psi_g.grad, diffraction.adj_raw(2 * ref, scan_i, prb, g.nz,
                                                 g.n, "xla"), 1e-5)
    assert close(prb_g.grad, diffraction.adj_probe_raw(2 * ref, scan_i, psi,
                                                       g.nprb, "xla"), 1e-5)


def test_pallas_run_launches_the_kernels(dev):
    """run(kernel='pallas'), joint: every operator of the classic body is a
    hybrid kernel, and no plain version and no fused kernel runs."""
    from tikejax_torch.solvers import run

    g = GEOMS[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64, device=dev)
    fns = [kernels.gather_probe_mul, kernels.scatter_conj_probe,
           kernels.adj_probe_reduce]
    others = [kernels.gather_probe_mul_reference,
              kernels.scatter_conj_probe_reference,
              kernels.adj_probe_reduce_reference, fused.fwd, fused.adj,
              fused.adj_probe, fused.grad_fused, fused.minf_fused]
    k0, o0 = [f.launches for f in fns], [f.launches for f in others]
    _, _, m = run(data, psi0, scan, 1.05 * prb, g, piter=8, kernel="pallas",
                  recover_prb=True)
    n = int(m["iters_run"])
    # Per iteration: G psi twice (object and probe pass) and a direction's
    # farplane twice; one object adjoint, one probe adjoint.
    assert [f.launches - b for f, b in zip(fns, k0)] == [4 * n, n, n]
    assert [f.launches for f in others] == o0
    assert float(m["minf"][n - 1]) < float(m["minf"][0])


# -- the materialized mode's kernels: adj_residual, fwd_quad_stats,
# ls_objectives ---------------------------------------------------------------

GAMMAS = [0.5 ** k for k in range(17)]


def materialized_inputs(g, dev):
    """psi, data, scan (one masked position), prb, the farplane G psi and
    small object and probe directions."""
    psi, data, scan_i, prb = inputs(g, dev)
    gen = torch.Generator(device=dev).manual_seed(2)

    def crandn(shape):
        return 0.1 * torch.complex(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))

    fpsi = fused.fwd_reference(psi, scan_i, prb, g.ndet)
    return psi, data, scan_i, prb, fpsi, crandn(g.psi_shape), crandn(
        g.prb_shape)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_adj_residual_matches_plain_version(dev, g, model):
    psi, data, scan_i, prb, fpsi, _, _ = materialized_inputs(g, dev)
    launches = fused.adj_residual.launches
    g_k, f_k = fused.adj_residual(fpsi, data, scan_i, prb, g.nz, g.n, model)
    g_r, f_r = fused.adj_residual_reference(fpsi, data, scan_i, prb, g.nz,
                                            g.n, model)
    assert fused.adj_residual.launches == launches + 1
    assert g_k.dtype == torch.complex64 and g_k.shape == g.psi_shape
    assert close(g_k, g_r)
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))
    again = fused.adj_residual(fpsi, data, scan_i, prb, g.nz, g.n, model)
    assert float(again[1]) == float(f_k)  # the objective is bitwise


@pytest.mark.parametrize("which", ["object", "probe"])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_fwd_quad_stats_matches_plain_version(dev, g, which):
    psi, _, scan_i, prb, fpsi, dpsi, dprb = materialized_inputs(g, dev)
    x, p = (dpsi, prb) if which == "object" else (psi, dprb)
    launches = fused.fwd_quad_stats.launches
    got = fused.fwd_quad_stats(x, scan_i, p, fpsi)
    ref = fused.fwd_quad_stats_reference(x, scan_i, p, fpsi)
    assert fused.fwd_quad_stats.launches == launches + 1
    for t, r in zip(got, ref):
        assert t.dtype == torch.float32 and t.shape == g.data_shape
        assert close(t, r)
    masked = scan_i[..., 0] < 0
    assert all(float(t[masked].abs().max()) == 0.0 for t in got)
    again = fused.fwd_quad_stats(x, scan_i, p, fpsi)
    assert all(torch.equal(t, u) for t, u in zip(got, again))


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", GEOMS, ids=str)
def test_ls_objectives_matches_plain_version(dev, g, model):
    psi, data, scan_i, prb, fpsi, dpsi, _ = materialized_inputs(g, dev)
    fd = fused.fwd_reference(dpsi, scan_i, prb, g.ndet)
    launches = linesearch.ls_objectives.launches
    got = linesearch.ls_objectives(fpsi, fd, data, GAMMAS, model)
    ref = linesearch.ls_objectives_reference(fpsi, fd, data, GAMMAS, model)
    assert linesearch.ls_objectives.launches == launches + 1
    assert got.dtype == torch.float32 and got.shape == (len(GAMMAS),)
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5
    again = linesearch.ls_objectives(fpsi, fd, data, GAMMAS, model)
    assert torch.equal(got, again)  # bitwise reproducible


def test_ls_objectives_takes_1_to_33_steps(dev):
    g = GEOMS[1]
    psi, data, scan_i, prb, fpsi, _, _ = materialized_inputs(g, dev)
    for k in (1, 33):
        steps = [0.9 ** j for j in range(k)]
        got = linesearch.ls_objectives(fpsi, fpsi, data, steps, "gaussian")
        ref = linesearch.ls_objectives_reference(fpsi, fpsi, data, steps,
                                                 "gaussian")
        assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5
    with pytest.raises(ValueError, match="steps"):
        linesearch.ls_objectives(fpsi, fpsi, data, [0.5] * 34, "gaussian")


def test_materialized_run_launches_the_kernels(dev):
    """run(memory='materialized'), with and without the fused line search,
    goes through the kernels and never through a plain version."""
    from tikejax_torch.solvers import run

    g = GEOMS[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64, device=dev)
    fns = [fused.fwd, fused.adj_residual, fused.fwd_quad_stats,
           linesearch.ls_objectives]
    plain = [fused.fwd_reference, fused.adj_residual_reference,
             fused.fwd_quad_stats_reference,
             linesearch.ls_objectives_reference]
    for fls, expect in ((False, [1, 1, 1, 0]), (True, [2, 1, 0, 1])):
        k0, p0 = [f.launches for f in fns], [f.launches for f in plain]
        _, _, m = run(data, psi0, scan, prb, g, piter=8,
                      memory="materialized", fused_linesearch=fls)
        n = int(m["iters_run"])
        assert [f.launches - b for f, b in zip(fns, k0)] == [
            e * n for e in expect]
        assert [f.launches for f in plain] == p0
        assert float(m["minf"][n - 1]) < float(m["minf"][0])


# -- the two variants of grad_fused, minf_fused, grad_prb_fused, fwd,
# adj_probe, adj_residual, fwd_quad_stats; ls_objectives' two kernels ---------

POW2_GEOMS = [
    Geometry(nz=97, n=101, nscan=37, ndet=64, nprb=48, ntheta=2, nmodes=2),
    Geometry(nz=64, n=64, nscan=9, ndet=16, nprb=12),
    Geometry(nz=64, n=64, nscan=9, ndet=32, nprb=20, nmodes=3),
    Geometry(nz=70, n=66, nscan=20, ndet=64, nprb=64),
    Geometry(nz=200, n=180, nscan=50, ndet=128, nprb=100),
    Geometry(nz=140, n=150, nscan=30, ndet=128, nprb=128, ntheta=2,
             nmodes=2),
]


def test_geometries_cover_both_variants():
    assert [fused.dft_variant(g.nprb, g.ndet, g.nmodes) for g in GEOMS] == [
        "gemm", "fft", "gemm", "gemm"]
    assert {fused.dft_variant(g.nprb, g.ndet, g.nmodes)
            for g in POW2_GEOMS} == {"fft"}


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_fft_grad_fused_matches_plain_version(dev, g, model, with_base):
    args = inputs(g, dev)
    base = base_for(g, dev) if with_base else None
    launches = fused.grad_fused.launches
    g_k, f_k = fused.grad_fused(*args, g.ndet, model, base=base)
    assert fused.grad_fused.launches == launches + 1
    assert fused.grad_fused.variant == "fft"
    g_r, f_r = fused.grad_fused_reference(*args, g.ndet, model, base=base)
    assert g_k.dtype == torch.complex64 and g_k.shape == g.psi_shape
    assert close(g_k, g_r)
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))
    # The objective and the gradient (summed in scan order) are bitwise
    # repeatable.
    g_2, f_2 = fused.grad_fused(*args, g.ndet, model, base=base)
    assert float(f_2) == float(f_k) and torch.equal(g_2, g_k)


@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_fft_adj_probe_matches_plain_version(dev, g):
    psi, _, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    launches = fused.adj_probe.launches
    p_k = fused.adj_probe(far, scan_i, psi, g.nprb)
    assert fused.adj_probe.launches == launches + 1
    assert fused.adj_probe.variant == "fft"
    assert p_k.dtype == torch.complex64 and p_k.shape == g.prb_shape
    assert close(p_k, fused.adj_probe_reference(far, scan_i, psi, g.nprb))
    for _ in range(2):  # bitwise repeatable
        assert torch.equal(p_k, fused.adj_probe(far, scan_i, psi, g.nprb))


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_fft_minf_fused_matches_plain_version(dev, g, model, with_base):
    """The FFT minf_fused against its plain version, bitwise repeatable,
    and equal bit for bit to grad_fused's objective on the same inputs: a
    line search compares the two."""
    psi, data, scan_i, prb = inputs(g, dev)
    base = base_for(g, dev) if with_base else None
    launches = fused.minf_fused.launches
    f_k = fused.minf_fused(psi, data, scan_i, prb, g.ndet, model, base=base)
    assert fused.minf_fused.launches == launches + 1
    assert fused.minf_fused.variant == "fft"
    f_r = fused.minf_fused_reference(psi, data, scan_i, prb, g.ndet, model,
                                     base=base)
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))
    again = fused.minf_fused(psi, data, scan_i, prb, g.ndet, model, base=base)
    assert float(again) == float(f_k)
    f_g = fused.grad_fused(psi, data, scan_i, prb, g.ndet, model,
                           base=base)[1]
    assert float(f_g) == float(f_k)
    if g.nmodes == 1:  # with and without the data prefetch: the same sum
        for prefetch in (False, True):
            assert float(fused._minf_fused_cuda(
                psi, data, scan_i, prb, g.ndet, model, base,
                prefetch=prefetch)) == float(f_k)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_fft_grad_prb_fused_matches_plain_version(dev, g, model):
    args = inputs(g, dev)
    launches = fused.grad_prb_fused.launches
    g_k, f_k = fused.grad_prb_fused(*args, g.ndet, model)
    assert fused.grad_prb_fused.launches == launches + 1
    assert fused.grad_prb_fused.variant == "fft"
    g_r, f_r = fused.grad_prb_fused_reference(*args, g.ndet, model)
    assert g_k.dtype == torch.complex64 and g_k.shape == g.prb_shape
    assert close(g_k, g_r)
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))
    g_2, f_2 = fused.grad_prb_fused(*args, g.ndet, model)
    assert torch.equal(g_2, g_k) and float(f_2) == float(f_k)  # bitwise
    assert float(fused.minf_fused(*args, g.ndet, model)) == float(f_k)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_fft_fwd_matches_plain_version(dev, g, with_base):
    """The FFT fwd against its plain version (complex and split views),
    bitwise repeatable (no reduction), masked frames zero or the base."""
    psi, _, scan_i, prb = inputs(g, dev)
    base = base_for(g, dev) if with_base else None
    launches = fused.fwd.launches
    out = fused.fwd(psi, scan_i, prb, g.ndet, base=base)
    assert fused.fwd.launches == launches + 1
    assert fused.fwd.variant == "fft"
    ref = fused.fwd_reference(psi, scan_i, prb, g.ndet, base=base)
    assert out.dtype == torch.complex64 and out.shape == g.farplane_shape
    assert close(out, ref)
    re, im = fused.fwd(psi, scan_i, prb, g.ndet, base=base, split_out=True)
    assert torch.equal(torch.complex(re, im), out)
    masked = scan_i[..., 0] < 0
    expect = base[masked] if with_base else torch.zeros_like(out[masked])
    assert torch.equal(out[masked], expect)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_fft_adj_residual_matches_plain_version(dev, g, model):
    """The FFT adj_residual against its plain version; its objective and
    its gradient (summed in scan order) bitwise repeatable."""
    psi, data, scan_i, prb, fpsi, _, _ = materialized_inputs(g, dev)
    launches = fused.adj_residual.launches
    g_k, f_k = fused.adj_residual(fpsi, data, scan_i, prb, g.nz, g.n, model)
    assert fused.adj_residual.launches == launches + 1
    assert fused.adj_residual.variant == "fft"
    g_r, f_r = fused.adj_residual_reference(fpsi, data, scan_i, prb, g.nz,
                                            g.n, model)
    assert g_k.dtype == torch.complex64 and g_k.shape == g.psi_shape
    assert close(g_k, g_r)
    assert abs(float(f_k) - float(f_r)) <= 1e-5 * abs(float(f_r))
    g_2, f_2 = fused.adj_residual(fpsi, data, scan_i, prb, g.nz, g.n, model)
    assert float(f_2) == float(f_k) and torch.equal(g_2, g_k)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("nmodes", [1, 2])
def test_fwd_feeds_minf_fused_bit_for_bit(dev, nmodes, with_base):
    """On 'fft', fwd's farplane is the one minf_fused forms inside, bit for
    bit: the objective of zeros on the base fwd(psi [, base]) is the
    objective of psi [on base]. A frozen base or an Anderson candidate
    made by fwd therefore rounds as the kernels that read it."""
    g = Geometry(nz=140, n=150, nscan=30, ndet=128, nprb=100, ntheta=2,
                 nmodes=nmodes)
    psi, data, scan_i, prb = inputs(g, dev)
    base = base_for(g, dev) if with_base else None
    far = fused.fwd(psi, scan_i, prb, g.ndet, base=base)
    zeros = torch.zeros_like(psi)
    for model in ("gaussian", "poisson"):
        direct = fused.minf_fused(psi, data, scan_i, prb, g.ndet, model,
                                  base=base)
        via = fused.minf_fused(zeros, data, scan_i, prb, g.ndet, model,
                               base=far)
        assert fused.fwd.variant == fused.minf_fused.variant == "fft"
        assert float(via) == float(direct)
        assert float(via) == float(fused.grad_fused(
            zeros, data, scan_i, prb, g.ndet, model, base=far)[1])


@pytest.mark.parametrize("threads", [512, 1024])
def test_both_variants_agree_at_one_shape(dev, threads):
    """The same inputs through both kernels of each function, forced: equal
    to 1e-5 of scale (both are fp32; the FFT sums log2(d) terms where the
    matrix product sums d)."""
    g = POW2_GEOMS[-1]
    psi, data, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    for base in (None, far):
        g_f, f_f = fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                          "gaussian", base, variant="fft",
                                          threads=threads)
        assert fused.grad_fused.variant == "fft"
        g_g, f_g = fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                          "gaussian", base, variant="gemm")
        assert fused.grad_fused.variant == "gemm"
        assert close(g_f, g_g, 1e-5)
        assert abs(float(f_f) - float(f_g)) <= 1e-5 * abs(float(f_g))
        m_f = fused._minf_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                     "gaussian", base, variant="fft",
                                     threads=threads)
        m_g = fused._minf_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                     "gaussian", base, variant="gemm")
        assert (fused.minf_fused.variant, float(m_f)) == ("gemm", float(f_f))
        assert abs(float(m_f) - float(m_g)) <= 1e-5 * abs(float(m_g))
    q_f, h_f = fused._grad_prb_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                          "gaussian", variant="fft",
                                          threads=threads)
    q_g, h_g = fused._grad_prb_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                          "gaussian", variant="gemm")
    assert close(q_f, q_g, 1e-5)
    assert abs(float(h_f) - float(h_g)) <= 1e-5 * abs(float(h_g))
    p_f = fused._adj_probe_cuda(far, scan_i, psi, g.nprb, variant="fft",
                                threads=threads)
    p_g = fused._adj_probe_cuda(far, scan_i, psi, g.nprb, variant="gemm")
    assert close(p_f, p_g, 1e-5)
    q_f = fused._fwd_quad_stats_cuda(0.1 * psi, scan_i, prb, far,
                                     variant="fft", threads=threads)
    assert fused.fwd_quad_stats.variant == "fft"
    q_g = fused._fwd_quad_stats_cuda(0.1 * psi, scan_i, prb, far,
                                     variant="gemm")
    assert fused.fwd_quad_stats.variant == "gemm"
    assert all(close(x, y, 1e-5) for x, y in zip(q_f, q_g))
    for base in (None, far):
        o_f = fused._fwd_cuda(psi, scan_i, prb, g.ndet, base, variant="fft",
                              threads=threads)
        assert fused.fwd.variant == "fft"
        o_g = fused._fwd_cuda(psi, scan_i, prb, g.ndet, base, variant="gemm")
        assert fused.fwd.variant == "gemm"
        assert close(o_f, o_g, 1e-5)
    fpsi = fused._fwd_cuda(psi, scan_i, prb, g.ndet, None, variant="gemm")
    for model in ("gaussian", "poisson"):
        r_f, s_f = fused._adj_residual_cuda(fpsi, data, scan_i, prb, g.nz,
                                            g.n, model, variant="fft",
                                            threads=threads)
        assert fused.adj_residual.variant == "fft"
        r_g, s_g = fused._adj_residual_cuda(fpsi, data, scan_i, prb, g.nz,
                                            g.n, model, variant="gemm")
        assert fused.adj_residual.variant == "gemm"
        assert close(r_f, r_g, 1e-5)
        assert abs(float(s_f) - float(s_g)) <= 1e-5 * abs(float(s_g))


def test_fft_variants_skip_masked_positions(dev):
    g = POW2_GEOMS[0]
    psi, data, scan_i, prb = inputs(g, dev)
    scan_i[..., 0] = -1
    grad, minf = fused.grad_fused(psi, data, scan_i, prb, g.ndet, "poisson")
    assert float(grad.abs().max()) == 0.0 and float(minf) == 0.0
    far = base_for(g, dev)
    assert float(fused.adj_probe(far, scan_i, psi, g.nprb).abs().max()) == 0
    assert float(fused.minf_fused(psi, data, scan_i, prb, g.ndet,
                                  "gaussian")) == 0.0
    grad, minf = fused.grad_prb_fused(psi, data, scan_i, prb, g.ndet,
                                      "gaussian")
    assert float(grad.abs().max()) == 0.0 and float(minf) == 0.0
    out = fused.fwd(psi, scan_i, prb, g.ndet)
    assert fused.fwd.variant == "fft" and float(out.abs().max()) == 0.0
    assert torch.equal(fused.fwd(psi, scan_i, prb, g.ndet, base=far), far)
    grad, minf = fused.adj_residual(far, data, scan_i, prb, g.nz, g.n,
                                    "poisson")
    assert fused.adj_residual.variant == "fft"
    assert float(grad.abs().max()) == 0.0 and float(minf) == 0.0


@pytest.mark.parametrize("which", ["object", "probe"])
@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_fft_fwd_quad_stats_matches_plain_version(dev, g, which):
    """The FFT fwd_quad_stats against its plain version for the object and
    the probe direction, bitwise repeatable, masked frames all zero."""
    psi, _, scan_i, prb, fpsi, dpsi, dprb = materialized_inputs(g, dev)
    x, p = (dpsi, prb) if which == "object" else (psi, dprb)
    launches = fused.fwd_quad_stats.launches
    got = fused.fwd_quad_stats(x, scan_i, p, fpsi)
    assert fused.fwd_quad_stats.launches == launches + 1
    assert fused.fwd_quad_stats.variant == "fft"
    ref = fused.fwd_quad_stats_reference(x, scan_i, p, fpsi)
    for t, r in zip(got, ref):
        assert t.dtype == torch.float32 and t.shape == g.data_shape
        assert close(t, r)
    masked = scan_i[..., 0] < 0
    assert all(float(t[masked].abs().max()) == 0.0 for t in got)
    again = fused.fwd_quad_stats(x, scan_i, p, fpsi)
    assert all(torch.equal(t, u) for t, u in zip(got, again))


@pytest.mark.parametrize("nmodes", [1, 2])
def test_fwd_quad_stats_of_fwd_gives_equal_statistics(dev, nmodes):
    """On 'fft' the direction's farplane is, bit for bit, the one fwd
    stores: with fp = fwd(x) and the direction x, a == b == c on every
    valid frame (a masked frame is zero in all three)."""
    g = Geometry(nz=140, n=150, nscan=30, ndet=128, nprb=100, ntheta=2,
                 nmodes=nmodes)
    psi, _, scan_i, prb = inputs(g, dev)
    far = fused.fwd(psi, scan_i, prb, g.ndet)
    a, b, c = fused.fwd_quad_stats(psi, scan_i, prb, far)
    assert fused.fwd.variant == fused.fwd_quad_stats.variant == "fft"
    valid = scan_i[..., 0] >= 0
    assert torch.equal(a[valid], b[valid]) and torch.equal(b[valid], c[valid])
    assert float(a[valid].min()) > 0.0
    assert all(float(t[~valid].abs().max()) == 0.0 for t in (a, b, c))


LS_GEOMS = [
    POW2_GEOMS[0],                                              # 64^2, 2 modes
    GEOMS[0],                                                   # 72^2
    Geometry(nz=64, n=64, nscan=9, ndet=33, nprb=20),           # odd side
]


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("k", [1, 2, 5, 17, 33])
@pytest.mark.parametrize("g", LS_GEOMS, ids=str)
def test_frame_ls_objectives_matches_plain_and_pixel(dev, g, k, model):
    """The frame-major ls_objectives at K steps (a masked position among
    the frames) against its plain version and the forced pixel-major
    kernel, each value within 1e-5; both bitwise repeatable."""
    psi, data, scan_i, prb, fpsi, dpsi, _ = materialized_inputs(g, dev)
    fd = fused.fwd_reference(dpsi, scan_i, prb, g.ndet)
    steps = [0.7 ** j for j in range(k)]
    launches = linesearch.ls_objectives.launches
    got = linesearch.ls_objectives(fpsi, fd, data, steps, model)
    assert linesearch.ls_objectives.launches == launches + 1
    assert linesearch.ls_objectives.variant == "frame"
    assert got.dtype == torch.float32 and got.shape == (k,)
    ref = linesearch.ls_objectives_reference(fpsi, fd, data, steps, model)
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5
    gamma = torch.tensor(steps, dtype=torch.float32, device=dev)
    old = linesearch._ls_objectives_cuda(fpsi, fd, data, gamma, model,
                                         variant="pixel")
    assert linesearch.ls_objectives.variant == "pixel"
    assert float(((got - old).abs() / old.abs()).max()) <= 1e-5
    assert torch.equal(got, linesearch.ls_objectives(fpsi, fd, data, steps,
                                                     model))
    assert torch.equal(old, linesearch._ls_objectives_cuda(
        fpsi, fd, data, gamma, model, variant="pixel"))


def test_frame_ls_objectives_reads_unaligned_views(dev):
    """Farplanes and data at an odd element offset (not aligned for the
    pair loads) are read pixel by pixel, to the same values within 1e-5."""
    g = POW2_GEOMS[0]
    psi, data, scan_i, prb, fpsi, dpsi, _ = materialized_inputs(g, dev)
    fd = fused.fwd_reference(dpsi, scan_i, prb, g.ndet)

    def odd(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = store[1:].view(x.shape)
        view.copy_(x)
        return view

    ref = linesearch.ls_objectives(fpsi, fd, data, GAMMAS, "poisson")
    got = linesearch.ls_objectives(odd(fpsi), odd(fd), odd(data), GAMMAS,
                                   "poisson")
    assert linesearch.ls_objectives.variant == "frame"
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5


def test_wrong_variant_raises(dev):
    """A variant that cannot run the shapes, an unknown one, or a block
    size without a kernel raises; nothing gives way to another path."""
    g = GEOMS[1]  # ndet = 32 is a power of two, GEOMS[0] is not
    psi, data, scan_i, prb = inputs(GEOMS[0], dev)
    far = base_for(GEOMS[0], dev)
    launches = (fused.grad_fused.launches, fused.adj_probe.launches)
    with pytest.raises(ValueError, match="'fft' variant takes ndet"):
        fused._grad_fused_cuda(psi, data, scan_i, prb, GEOMS[0].ndet,
                               "gaussian", None, variant="fft")
    with pytest.raises(ValueError, match="'fft' variant takes ndet"):
        fused._adj_probe_cuda(far, scan_i, psi, GEOMS[0].nprb, variant="fft")
    with pytest.raises(ValueError, match="fwd: the 'fft' variant takes"):
        fused._fwd_cuda(psi, scan_i, prb, GEOMS[0].ndet, None, variant="fft")
    with pytest.raises(ValueError, match="adj_residual: the 'fft' variant"):
        fused._adj_residual_cuda(far, data, scan_i, prb, GEOMS[0].nz,
                                 GEOMS[0].n, "gaussian", variant="fft")
    with pytest.raises(ValueError, match="fwd_quad_stats: the 'fft' var"):
        fused._fwd_quad_stats_cuda(psi, scan_i, prb, far, variant="fft")
    with pytest.raises(ValueError, match="ls_objectives: unknown variant"):
        linesearch._ls_objectives_cuda(
            far, far, data, torch.ones(3, device=dev), "gaussian",
            variant="fft")
    counts = (fused.fwd.launches, fused.adj_residual.launches,
              fused.fwd_quad_stats.launches, linesearch.ls_objectives.launches)
    psi, data, scan_i, prb = inputs(g, dev)
    with pytest.raises(ValueError, match="unknown variant"):
        fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet, "gaussian",
                               None, variant="cufft")
    with pytest.raises(RuntimeError, match="occupancy query"):
        fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet, "gaussian",
                               None, variant="fft", threads=1024)
    with pytest.raises(RuntimeError, match="occupancy query"):
        fused._adj_probe_cuda(base_for(g, dev), scan_i, psi, g.nprb,
                              variant="fft", threads=256)
    with pytest.raises(ValueError, match="prefetch needs one mode"):
        g3 = POW2_GEOMS[2]  # three modes
        fused._minf_fused_cuda(*inputs(g3, dev), g3.ndet, "gaussian", None,
                               prefetch=True)
    with pytest.raises(RuntimeError, match="occupancy query"):
        fused._fwd_cuda(psi, scan_i, prb, g.ndet, None, threads=1024)
    far = base_for(g, dev)
    with pytest.raises(RuntimeError, match="occupancy query"):
        fused._adj_residual_cuda(far, data, scan_i, prb, g.nz, g.n,
                                 "gaussian", threads=256)
    with pytest.raises(RuntimeError, match="occupancy query"):
        fused._fwd_quad_stats_cuda(psi, scan_i, prb, far, threads=1024)
    # A farplane at an odd complex offset: 8-byte aligned, not 16.
    store = torch.empty(far.numel() + 1, dtype=torch.complex64, device=dev)
    odd = store[1:].view(far.shape)
    odd.copy_(far)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused.adj_residual(odd, data, scan_i, prb, g.nz, g.n, "gaussian")
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused.fwd_quad_stats(psi, scan_i, prb, odd)
    assert (fused.grad_fused.launches, fused.adj_probe.launches) == launches
    assert (fused.fwd.launches, fused.adj_residual.launches,
            fused.fwd_quad_stats.launches,
            linesearch.ls_objectives.launches) == counts


# -- adj on the frame's FFT; the persistent gather_probe_mul -----------------

ADJ_GEOMS = [
    Geometry(nz=97, n=101, nscan=37, ndet=64, nprb=48, ntheta=2),
    Geometry(nz=97, n=101, nscan=37, ndet=64, nprb=48, ntheta=2, nmodes=2),
    Geometry(nz=200, n=180, nscan=50, ndet=128, nprb=100),
    Geometry(nz=140, n=150, nscan=30, ndet=128, nprb=128, nmodes=2),
]


@pytest.mark.parametrize("variant", ["fft", "gemm"])
@pytest.mark.parametrize("g", ADJ_GEOMS, ids=str)
def test_adj_variants_match_plain_version(dev, g, variant):
    """Both kernels of adj, forced, against the plain version (a masked
    position among the frames) to 1e-4 of scale; two runs equal bit for
    bit (the tile kernel sums in scan order); the public function takes
    'fft' here."""
    _, _, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    launches = fused.adj.launches
    tiles = kernels.scatter_conj_probe.launches
    got = fused._adj_cuda(far, scan_i, prb, g.nz, g.n, variant=variant)
    chunks = -(-g.nscan // fused.adj_chunk(g.ntheta, g.nscan, g.nmodes,
                                           g.nprb))
    assert fused.adj.launches == launches + chunks
    assert kernels.scatter_conj_probe.launches == tiles + chunks
    assert fused.adj.variant == variant
    assert got.dtype == torch.complex64 and got.shape == g.psi_shape
    assert close(got, fused.adj_reference(far, scan_i, prb, g.nz, g.n))
    assert torch.equal(fused._adj_cuda(far, scan_i, prb, g.nz, g.n,
                                       variant=variant), got)
    fused.adj(far, scan_i, prb, g.nz, g.n)
    assert fused.adj.variant == "fft"
    scan_i[..., 0] = -1
    none = fused._adj_cuda(far, scan_i, prb, g.nz, g.n, variant=variant)
    assert float(none.abs().max()) == 0.0


@pytest.mark.parametrize("variant", ["fft", "gemm"])
@pytest.mark.parametrize("g", ADJ_GEOMS[1:3], ids=str)
def test_adj_is_the_same_bits_whatever_the_chunk(dev, g, variant):
    """The frames of each chunk of positions are summed by the tile kernel
    continuing from the partial object the chunk before stored: one chunk,
    chunks of 1, 7 and 16 positions (a masked one among them), and the
    default, all the same bits."""
    _, _, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    whole = fused._adj_cuda(far, scan_i, prb, g.nz, g.n, variant=variant,
                            chunk=g.nscan)
    for chunk in (1, 7, 16, None):
        launches = fused.adj.launches
        tiles = kernels.scatter_conj_probe.launches
        got = fused._adj_cuda(far, scan_i, prb, g.nz, g.n, variant=variant,
                              chunk=chunk)
        assert torch.equal(got, whole), chunk
        if chunk is not None:
            # One frame-kernel launch and one tile launch a chunk.
            chunks = -(-g.nscan // chunk)
            assert fused.adj.launches == launches + chunks
            assert kernels.scatter_conj_probe.launches == tiles + chunks


@pytest.mark.parametrize("g", ADJ_GEOMS, ids=str)
def test_adj_atomic_kernel_matches_plain_version(dev, g):
    """The one-pass FFT kernel with fp32 atomics, kept for timing the two
    designs in turns, still agrees with the plain version."""
    _, _, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    tiles = kernels.scatter_conj_probe.launches
    got = fused._adj_cuda(far, scan_i, prb, g.nz, g.n, variant="atomic")
    assert fused.adj.variant == "atomic"
    assert kernels.scatter_conj_probe.launches == tiles
    assert close(got, fused.adj_reference(far, scan_i, prb, g.nz, g.n))
    assert close(got, fused.adj(far, scan_i, prb, g.nz, g.n), 1e-5)


# The reference's operator accuracy of its most accurate tier
# (tikejax/ops/diffraction.py kernel notes): fused_hp ~4e-7 (fused_mp and
# fused_mx ~8e-6).
HP_BOUND = 4e-7


def oracle_err(got, ref):
    """max |got - ref| / max |ref| against a complex128 oracle."""
    diff = (got.to(torch.complex128) - ref).abs().max()
    return float(diff / ref.abs().max())


@pytest.mark.parametrize("nmodes", [1, 4])
@pytest.mark.parametrize("ndet", [64, 128])
def test_fft_operators_against_a_complex128_oracle(dev, ndet, nmodes):
    """The 'fft' fwd farplane, adj, adj_probe, adj_residual and
    grad_fused against the oracle operators run in complex128 on the card,
    on the same (complex64) inputs: within the reference's fused_hp bound,
    ~4e-7 of scale (every fused tier maps to these kernels). grad_fused's
    gradient is adj_residual's of the farplane fwd stores (bit for bit,
    held here), so its oracle is adj_residual's in complex128 on that
    farplane: the gradient's own conditioning (the likelihood factor of a
    faint farplane pixel) is not the kernel's error."""
    g = Geometry(nz=256, n=256, nscan=400, ndet=ndet, nprb=ndet,
                 nmodes=nmodes)
    psi, data, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    c128 = [x.to(torch.complex128) for x in (psi, prb, far)]
    far_psi = fused.fwd(psi, scan_i, prb, ndet)
    grad, _ = fused.grad_fused(psi, data, scan_i, prb, ndet, "gaussian")
    assert torch.equal(grad, fused.adj_residual(far_psi, data, scan_i, prb,
                                                g.nz, g.n, "gaussian")[0])
    errs = {
        "fwd": oracle_err(fused.fwd(psi, scan_i, prb, ndet),
                          diffraction.fwd_raw(c128[0], scan_i, c128[1], ndet,
                                              kernel="xla")),
        "adj": oracle_err(fused.adj(far, scan_i, prb, g.nz, g.n),
                          diffraction.adj_raw(c128[2], scan_i, c128[1], g.nz,
                                              g.n, kernel="xla")),
        "adj_probe": oracle_err(
            fused.adj_probe(far, scan_i, psi, g.nprb),
            diffraction.adj_probe_raw(c128[2], scan_i, c128[0], g.nprb,
                                      kernel="xla")),
        "adj_residual": oracle_err(
            fused.adj_residual(far, data, scan_i, prb, g.nz, g.n,
                               "gaussian")[0],
            fused.adj_residual_reference(c128[2], data.double(), scan_i,
                                         c128[1], g.nz, g.n,
                                         "gaussian")[0]),
        "grad_fused": oracle_err(
            grad, fused.adj_residual_reference(
                far_psi.to(torch.complex128), data.double(), scan_i, c128[1],
                g.nz, g.n, "gaussian")[0]),
    }
    assert fused.fwd.variant == fused.adj.variant == (
        fused.adj_probe.variant) == fused.adj_residual.variant == (
        fused.grad_fused.variant) == "fft"
    print(f"{ndet}^2, {nmodes} mode(s): " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    assert all(v <= HP_BOUND for v in errs.values()), errs


@pytest.mark.parametrize("nmodes", [1, 2])
def test_fwd_and_adj_are_a_pair_on_fft(dev, nmodes):
    """<fwd(x), y> = <x, adj(y)> to 1e-5 on 'fft': both go through the
    frame's FFT in shared memory (the inner products in complex128)."""
    g = Geometry(nz=140, n=150, nscan=30, ndet=128, nprb=100, ntheta=2,
                 nmodes=nmodes)
    psi, _, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)

    def vdot(a, b):
        return complex(torch.vdot(a.reshape(-1).to(torch.complex128),
                                  b.reshape(-1).to(torch.complex128)))

    lhs = vdot(fused.fwd(psi, scan_i, prb, g.ndet), far)
    rhs = vdot(psi, fused.adj(far, scan_i, prb, g.nz, g.n))
    assert fused.fwd.variant == fused.adj.variant == "fft"
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_adj_fft_refuses_an_unaligned_farplane(dev):
    g = ADJ_GEOMS[0]
    _, _, scan_i, prb = inputs(g, dev)
    far = base_for(g, dev)
    store = torch.empty(far.numel() + 1, dtype=torch.complex64, device=dev)
    odd = store[1:].view(far.shape)
    odd.copy_(far)
    launches = fused.adj.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused.adj(odd, scan_i, prb, g.nz, g.n)
    assert fused.adj.launches == launches
    # The 'gemm' kernel reads 8 bytes at a time and takes it.
    assert close(fused._adj_cuda(odd, scan_i, prb, g.nz, g.n,
                                 variant="gemm"),
                 fused.adj_reference(far, scan_i, prb, g.nz, g.n))


GATHER_GEOMS = [
    Geometry(nz=97, n=100, nscan=37, ndet=56, nprb=56, ntheta=2, nmodes=2),
    Geometry(nz=97, n=101, nscan=37, ndet=48, nprb=48, ntheta=2, nmodes=2),
    Geometry(nz=97, n=100, nscan=37, ndet=55, nprb=55, ntheta=2, nmodes=2),
    Geometry(nz=97, n=101, nscan=37, ndet=55, nprb=55, ntheta=2, nmodes=2),
    Geometry(nz=64, n=64, nscan=9, ndet=16, nprb=5),
    Geometry(nz=200, n=180, nscan=50, ndet=128, nprb=128),
]


@pytest.mark.parametrize("g", GATHER_GEOMS, ids=str)
def test_persistent_gather_equals_the_pixel_kernel(dev, g):
    """The persistent gather_probe_mul against the forced pixel kernel it
    replaced: equal bit for bit (even and odd sx, even and odd n and nprb,
    a masked position, 2 angles x 2 modes), bitwise repeatable, masked
    frames all zero, within 1e-5 of scale of the plain version; an object
    at an odd complex offset (no 16-byte loads) gives the same bits."""
    psi, _, scan_i, prb = inputs(g, dev)
    scan_i[0, 0] = torch.tensor([1, 1], dtype=torch.int32)
    scan_i[0, 1] = torch.tensor([2, 2], dtype=torch.int32)
    valid = scan_i[..., 0] >= 0
    assert {0, 1} <= set((scan_i[..., 1][valid] % 2).tolist())
    launches = kernels.gather_probe_mul.launches
    got = kernels.gather_probe_mul(psi, scan_i, prb)
    assert kernels.gather_probe_mul.variant == "persistent"
    old = kernels._gather_probe_mul_cuda(psi, scan_i, prb, variant="pixel")
    assert kernels.gather_probe_mul.variant == "pixel"
    assert kernels.gather_probe_mul.launches == launches + 2
    assert got.shape == old.shape == (g.ntheta, g.nscan, g.nmodes, g.nprb,
                                      g.nprb)
    assert torch.equal(got, old)
    assert torch.equal(got, kernels.gather_probe_mul(psi, scan_i, prb))
    assert float(got[~valid].abs().max()) == 0.0
    assert close(got, kernels.gather_probe_mul_reference(psi, scan_i, prb),
                 1e-5)
    store = torch.empty(psi.numel() + 1, dtype=torch.complex64, device=dev)
    odd = store[1:].view(psi.shape)
    odd.copy_(psi)
    assert torch.equal(kernels.gather_probe_mul(odd, scan_i, prb), got)


SCATTER_GEOMS = [
    Geometry(nz=97, n=101, nscan=37, ndet=72, nprb=56, ntheta=2, nmodes=2),
    Geometry(nz=97, n=102, nscan=37, ndet=64, nprb=55, ntheta=2, nmodes=2),
    Geometry(nz=97, n=101, nscan=37, ndet=48, nprb=48, ntheta=2, nmodes=2),
    Geometry(nz=97, n=102, nscan=37, ndet=64, nprb=48, ntheta=2, nmodes=2),
    Geometry(nz=97, n=101, nscan=37, ndet=64, nprb=48, ntheta=2, nmodes=3),
    Geometry(nz=70, n=66, nscan=20, ndet=48, nprb=48, nmodes=5),
    Geometry(nz=64, n=64, nscan=9, ndet=16, nprb=5),
    Geometry(nz=200, n=180, nscan=50, ndet=128, nprb=128),
]


def scatter_inputs(g, dev):
    """Frames as the adjoint operators hand them over (strided when ndet >
    nprb), the probe and a scan with a masked position and windows on the
    object's last row and column."""
    _, _, scan_i, prb = inputs(g, dev)
    scan_i[0, 0] = torch.tensor([g.nz - g.nprb, g.n - g.nprb])
    scan_i[0, 1] = torch.tensor([0, g.n - g.nprb])
    scan_i[-1, -1] = torch.tensor([g.nz - g.nprb, 0])
    return cropped_frames(g, dev), scan_i, prb


@pytest.mark.parametrize("g", SCATTER_GEOMS, ids=str)
def test_tile_scatter_matches_plain_and_atomic(dev, g):
    """The tile kernel on awkward sizes (odd and even n, nprb 56, 55, 48
    and 5, partial edge tiles, strided crops, 2 angles x 2 modes, 3 and 5
    modes -- a chunk of modes partly empty --, windows on the last row and
    column): within 1e-5 of scale of the plain version and of the forced
    atomic kernel, bitwise repeatable."""
    near, scan_i, prb = scatter_inputs(g, dev)
    launches = kernels.scatter_conj_probe.launches
    got = kernels.scatter_conj_probe(near, scan_i, prb, g.nz, g.n)
    assert kernels.scatter_conj_probe.variant == "tile"
    old = kernels._scatter_conj_probe_cuda(near, scan_i, prb, g.nz, g.n,
                                           variant="atomic")
    assert kernels.scatter_conj_probe.variant == "atomic"
    assert kernels.scatter_conj_probe.launches == launches + 2
    assert got.shape == old.shape == g.psi_shape
    assert close(got, kernels.scatter_conj_probe_reference(
        near, scan_i, prb, g.nz, g.n), 1e-5)
    assert close(got, old, 1e-5)
    assert torch.equal(got, kernels.scatter_conj_probe(near, scan_i, prb,
                                                       g.nz, g.n))


@pytest.mark.parametrize("g", SCATTER_GEOMS[:2] + SCATTER_GEOMS[4:6],
                         ids=str)
def test_tile_scatter_bits_do_not_depend_on_the_layout(dev, g):
    """The frames' strides and where the scan lies in memory change the
    addresses, not the order in which a pixel sums its positions and their
    modes: a strided crop and its contiguous copy, and a scan at an offset
    that is not 8-byte aligned (copied by the wrapper), give the same
    bits."""
    near, scan_i, prb = scatter_inputs(g, dev)
    want = kernels.scatter_conj_probe(near, scan_i, prb, g.nz, g.n)
    store = torch.empty(scan_i.numel() + 1, dtype=torch.int32, device=dev)
    odd = store[1:].view(scan_i.shape)
    odd.copy_(scan_i)
    assert odd.data_ptr() % 8
    for frames, scan in ((near.contiguous(), scan_i), (near, odd)):
        assert torch.equal(kernels.scatter_conj_probe(frames, scan, prb,
                                                      g.nz, g.n), want)


def test_tile_scatter_writes_every_pixel(dev):
    """The tile kernel's output is not zeroed before it runs: a pixel that
    no window covers comes back exactly 0 even where the memory it reuses
    held NaN, and so does every pixel when every position is masked."""
    g = Geometry(nz=70, n=66, nscan=4, ndet=16, nprb=16, ntheta=2,
                 nmodes=2)
    near, scan_i, prb = scatter_inputs(g, dev)
    scan_i[:] = torch.tensor([[0, 0], [30, 40], [54, 50], [-1, 3]])
    covered = torch.zeros(g.psi_shape, dtype=torch.bool, device=dev)
    covered[:, :16, :16] = covered[:, 30:46, 40:56] = True
    covered[:, 54:70, 50:66] = True
    for masked in (False, True):
        if masked:
            scan_i[..., 0] = -1
        junk = torch.full(g.psi_shape, float("nan"), dtype=torch.complex64,
                          device=dev)
        del junk  # the allocator hands this block to the kernel's output
        got = kernels.scatter_conj_probe(near, scan_i, prb, g.nz, g.n)
        assert bool(torch.isfinite(got).all())
        assert float(got[~covered].abs().max()) == 0.0
        if masked:
            assert float(got.abs().max()) == 0.0
        else:
            assert float(got[covered].abs().min()) > 0.0
            assert close(got, kernels.scatter_conj_probe_reference(
                near, scan_i, prb, g.nz, g.n), 1e-5)


# -- the tile kernel's chunk skip -------------------------------------------

# A scan longer than one 256-position chunk, on two angles and two modes, so
# that chunks miss tiles and a launch can start past a chunk's start.
LONG_SCAN = Geometry(nz=200, n=180, nscan=700, ndet=32, nprb=24, ntheta=2,
                     nmodes=2)


@pytest.mark.parametrize("g", SCATTER_GEOMS + [LONG_SCAN], ids=str)
def test_tile_scatter_skip_writes_the_same_bits(dev, g):
    """Skipping the chunks of 256 positions whose box misses the tile
    leaves each pixel's positions in scan order: the same bits as the walk
    over every chunk, on the awkward cases (a masked position, windows on
    the last row and column, 2 angles x 2 modes, partial edge tiles), and
    for a launch on the positions from ``a`` on with the whole scan's boxes
    (``first=a``: its walk starts with part of a chunk), whose sum is also
    the plain version's on those positions."""
    near, scan_i, prb = scatter_inputs(g, dev)
    want = kernels._scatter_conj_probe_cuda(near, scan_i, prb, g.nz, g.n,
                                            skip=False)
    assert torch.equal(kernels.scatter_conj_probe(near, scan_i, prb, g.nz,
                                                  g.n), want)
    boxes = kernels.scatter_boxes(scan_i, g.nz, g.n, g.nprb)
    for a in sorted({1, g.nscan // 2, min(300, g.nscan - 1)}):
        got, walked = (kernels._scatter_conj_probe_cuda(
            near[:, a:], scan_i[:, a:], prb, g.nz, g.n, boxes=boxes,
            first=a, skip=skip) for skip in (True, False))
        assert torch.equal(got, walked), a
        assert close(got, kernels.scatter_conj_probe_reference(
            near[:, a:], scan_i[:, a:], prb, g.nz, g.n), 1e-5), a


@pytest.mark.parametrize("which", ["grad_fused", "adj_residual", "adj"])
def test_scatter_skip_lines_up_with_the_chunks(dev, which):
    """The object scatters on chunks that start mid-angle, past a
    256-position chunk's start (300 and 555 frames of grad_fused and
    adj_residual, 300 positions of adj), each launch skipping by the whole
    scan's boxes from its first position: the same bits as one chunk of
    everything."""
    g = LONG_SCAN
    if which == "adj":
        _, _, scan_i, prb = inputs(g, dev)
        far = base_for(g, dev)
        whole = fused._adj_cuda(far, scan_i, prb, g.nz, g.n, chunk=g.nscan)
        assert torch.equal(fused._adj_cuda(far, scan_i, prb, g.nz, g.n,
                                           chunk=300), whole)
        return
    whole, f_whole = two_pass(g, dev, which, chunk=g.ntheta * g.nscan)
    for chunk in (300, 555):
        got, f_got = two_pass(g, dev, which, chunk=chunk)
        assert torch.equal(got, whole) and float(f_got) == float(f_whole)


def test_scatter_boxes_are_kept_beside_the_scan(dev):
    """The box plan is made once per scan and made again when the scan
    changes in place."""
    g = LONG_SCAN
    _, _, scan_i, _ = inputs(g, dev)
    boxes = kernels.scatter_boxes(scan_i, g.nz, g.n, g.nprb)
    assert kernels.scatter_boxes(scan_i, g.nz, g.n, g.nprb) is boxes
    assert torch.equal(boxes, kernels.scatter_box_plan(scan_i, g.nz, g.n,
                                                       g.nprb))
    scan_i[0, 0] = torch.tensor([-1, 0])
    again = kernels.scatter_boxes(scan_i, g.nz, g.n, g.nprb)
    assert again is not boxes and torch.equal(
        again, kernels.scatter_box_plan(scan_i, g.nz, g.n, g.nprb))


# -- grad_fused and adj_residual in scan order ------------------------------

SCAN_ORDER_GEOMS = [POW2_GEOMS[0], POW2_GEOMS[4], POW2_GEOMS[5], GEOMS[0]]


def two_pass(g, dev, which, **kw):
    """grad_fused of (psi, data, scan, prb), or adj_residual of fwd's
    farplane of them, through the private wrapper with ``kw``."""
    psi, data, scan_i, prb = inputs(g, dev)
    if which == "grad_fused":
        return fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet,
                                      "poisson", None, **kw)
    far = fused.fwd(psi, scan_i, prb, g.ndet)
    return fused._adj_residual_cuda(far, data, scan_i, prb, g.nz, g.n,
                                    "poisson", **kw)


@pytest.mark.parametrize("which", ["grad_fused", "adj_residual"])
@pytest.mark.parametrize("g", SCAN_ORDER_GEOMS, ids=str)
def test_two_pass_is_the_same_bits_whatever_the_chunk(dev, g, which):
    """The frame kernel's chunks of frames (one, of 1, 7 and 16 frames
    across the angles, a masked one among them, and the default), each
    summed by the tile kernel continuing from the running sums in double:
    the gradient and the objective the same bits; one frame-kernel launch
    a chunk."""
    counter = getattr(fused, which)
    whole, f_whole = two_pass(g, dev, which, chunk=g.ntheta * g.nscan)
    for chunk in (1, 7, 16, None):
        launches = counter.launches
        got, f_got = two_pass(g, dev, which, chunk=chunk)
        assert torch.equal(got, whole) and float(f_got) == float(
            f_whole), chunk
        size = fused.frame_chunk(g.nmodes, g.nprb) if chunk is None else chunk
        assert counter.launches == launches + -(-g.ntheta * g.nscan // size)


@pytest.mark.parametrize("which", ["grad_fused", "adj_residual"])
@pytest.mark.parametrize("g", SCAN_ORDER_GEOMS[:3], ids=str)
def test_two_pass_against_the_atomic_kernel(dev, g, which):
    """The forced one-pass kernel with fp32 atomics that the two passes
    replaced: the gradient within 1e-5 of scale, the objective the same
    bits (the same frames per block, in the same order); grad_fused's is
    minf_fused's too."""
    got, f_got = two_pass(g, dev, which)
    old, f_old = two_pass(g, dev, which, variant="atomic")
    assert getattr(fused, which).variant == "atomic"
    assert close(got, old, 1e-5) and float(f_got) == float(f_old)
    if which == "grad_fused":
        psi, data, scan_i, prb = inputs(g, dev)
        assert float(fused.minf_fused(psi, data, scan_i, prb, g.ndet,
                                      "poisson")) == float(f_got)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("g", POW2_GEOMS, ids=str)
def test_grad_fused_is_adj_residual_of_fwd(dev, g, model):
    """On 'fft' the two share their inverse half: grad_fused(psi)'s
    gradient is adj_residual(fwd(psi))'s, bit for bit."""
    psi, data, scan_i, prb = inputs(g, dev)
    grad, _ = fused.grad_fused(psi, data, scan_i, prb, g.ndet, model)
    far = fused.fwd(psi, scan_i, prb, g.ndet)
    again, _ = fused.adj_residual(far, data, scan_i, prb, g.nz, g.n, model)
    assert fused.grad_fused.variant == fused.adj_residual.variant == "fft"
    assert torch.equal(grad, again)


def test_atomic_variants_take_fft_sizes_without_a_base(dev):
    g = POW2_GEOMS[0]
    psi, data, scan_i, prb = inputs(g, dev)
    with pytest.raises(ValueError, match="no base"):
        fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet, "gaussian",
                               base_for(g, dev), variant="atomic")
    g = GEOMS[0]
    psi, data, scan_i, prb = inputs(g, dev)
    with pytest.raises(ValueError, match="'fft' variant takes ndet"):
        fused._grad_fused_cuda(psi, data, scan_i, prb, g.ndet, "gaussian",
                               None, variant="atomic")


# -- the process group on the card, and the span report's device time ----


def test_an_nccl_group_of_one_runs_run_sharded(dev, tmp_path):
    """The backend rule gives one rank on one card NCCL; ``run_sharded`` on
    its one-rank ``('scan',)`` mesh equals ``solvers.run`` up to the order
    of the sums (no sum crosses a rank here)."""
    import torch.distributed as dist

    from tikejax_torch import parallel
    from tikejax_torch.solvers import run
    from tikejax_torch.solvers.cg import all_reduce

    g = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    psi0 = torch.ones((1, g.nz, g.n), dtype=torch.complex64, device=dev)
    want = run(data, psi0, scan.clone(), prb, g, piter=8)
    backend = parallel.join_group(0, 1, f"file://{tmp_path}/pg", "cuda",
                                  timeout=60)
    try:
        assert backend == "nccl" == dist.get_backend()
        mesh = parallel.make_mesh(1)
        got = parallel.run_sharded(data, psi0, scan.clone(), prb, g, mesh,
                                   piter=8)
        assert int(got[2]["iters_run"]) == int(want[2]["iters_run"]) == 8
        scale = want[0].abs().max()
        assert float((got[0] - want[0]).abs().max() / scale) < 1e-5
        # A collective on the card stays there.
        x = all_reduce(torch.ones(3, device=dev), dist.group.WORLD)
        assert x.device == dev and torch.equal(x, torch.ones(3, device=dev))
    finally:
        dist.destroy_process_group()


def test_span_device_time_is_its_kernels_time(dev):
    """``device_s`` of a span that launches one known kernel is that
    kernel's time on the card, as the profiler's trace has it (here the
    report's busy time: the window holds no other device work)."""
    from tikejax_torch.utils.profiling import span, span_report

    x = torch.ones(2**26, device=dev)
    x.mul_(2)
    torch.cuda.synchronize(dev)
    with span_report() as report:
        with span("outer"):
            with span("one_kernel"):
                x.mul_(2)
            with span("no_kernel"):
                pass
    f = report.by_name["one_kernel"]
    assert f.launches == 1 and f.device_s > 0
    assert f.device_s == pytest.approx(report.busy_s, rel=1e-9)
    assert report.by_name["outer"].device_s == f.device_s
    assert report.by_name["no_kernel"].device_s == 0
