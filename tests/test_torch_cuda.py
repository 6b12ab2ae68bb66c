"""The CUDA kernels ``grad_fused`` (with and without a base), ``fwd``,
``minf_fused``, ``grad_prb_fused``, ``adj`` and ``adj_probe`` against their
plain PyTorch versions, on the card. Marked ``cuda``: without a CUDA device
every test here skips. On a machine with a card (the JAX package need not
be installed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the JAX package's fused parity bound for the gradients, the
adjoints and the farplane (1e-4 of their scale) and 1e-5 relative for the
objective -- both sides are fp32 and sum in different orders. The probe
reductions (``grad_prb_fused``, ``adj_probe``) are bitwise reproducible;
the object scatters (``grad_fused``, ``adj``) only up to summation order.
"""

import pytest
import torch

from tikejax_torch import Geometry
from tikejax_torch.models import make_problem
from tikejax_torch.ops import diffraction, fused
from tikejax_torch.ops.patches import scan_to_int

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
    run the kernels; 'pallas' still raises."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        diffraction.adj_raw(ref, scan_i, prb, g.nz, g.n, "pallas")
