"""The CUDA ``grad_fused`` kernel against its plain PyTorch version, on the
card. Marked ``cuda``: without a CUDA device every test here skips. On a
machine with a card (the JAX package need not be installed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the JAX package's fused parity bound for the gradient (1e-4 of
its scale) and 1e-5 relative for the objective -- both sides are fp32 and
sum in different orders.
"""

import pytest
import torch

from tikejax_torch import Geometry
from tikejax_torch.models import make_problem
from tikejax_torch.ops import fused
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
