"""The port's ``grad_fused`` (its plain path on the CPU) against the JAX
package: the oracle gradient ``adj(residual(fwd(psi)))`` in complex128, and
the Pallas kernel ``pallas_fused.grad_fused`` in interpret mode in
complex64, where the tolerances are the JAX package's own fused parity
bounds (gradient 1e-4 of its scale, objective 1e-5 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tikejax
from tikejax.models import likelihoods as jlik
from tikejax.ops import diffraction as jdiff
from tikejax.ops import pallas_fused
from tikejax_torch.ops import fused
from tikejax_torch.ops.patches import scan_to_int
from tikejax_torch.utils import to_numpy, to_torch

GEOM = tikejax.Geometry(nz=40, n=37, nscan=9, ndet=24, nprb=16, ntheta=2,
                        nmodes=2)


def make_inputs(g, dtype, seed=0):
    """psi, data, int scan (last position of the last angle a masked
    dummy), prb. The data are intensities of a different object, so the
    gradient at psi is O(1)."""
    rng = np.random.default_rng(seed)

    def crand(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)

    psi, psi2, prb = (crand(g.psi_shape), crand(g.psi_shape),
                      crand(g.prb_shape))
    scan = np.stack([rng.integers(0, g.nz - g.nprb + 1, g.scan_shape[:2]),
                     rng.integers(0, g.n - g.nprb + 1, g.scan_shape[:2])],
                    -1).astype(np.int32)
    far = np.asarray(jdiff.fwd_raw(psi2, scan.astype(np.float64), prb,
                                   g.ndet))
    data = np.sum(np.abs(far)**2, axis=2).astype(np.real(psi).dtype)
    scan[-1, -1, 0] = -1
    return psi, data, scan, prb


def port_grad_fused(psi, data, scan, prb, g, model):
    grad, minf = fused.grad_fused(to_torch(psi), to_torch(data),
                                  scan_to_int(to_torch(scan)), to_torch(prb),
                                  g.ndet, model)
    return to_numpy(grad), float(minf)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_plain_path_matches_jax_oracle(model):
    """complex128, 1e-10: the objective skips the masked position."""
    psi, data, scan, prb = make_inputs(GEOM, np.complex128)
    g = GEOM
    minf_fn, resid_fn = jlik.get_model(model)
    sc = scan.astype(np.float64)
    far = jdiff.fwd_raw(psi, sc, prb, g.ndet)
    grad_j = np.asarray(jdiff.adj_raw(resid_fn(far, data), sc, prb, g.nz,
                                      g.n))
    valid = scan[..., 0] >= 0
    minf_j = float(minf_fn(np.asarray(far)[valid][None], data[valid][None]))
    grad_t, minf_t = port_grad_fused(psi, data, scan, prb, g, model)
    assert grad_t.dtype == np.complex128
    assert np.abs(grad_t - grad_j).max() < 1e-10 * np.abs(grad_j).max()
    assert abs(minf_t - minf_j) < 1e-10 * abs(minf_j)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_plain_path_matches_pallas_kernel(model):
    """complex64 against the TPU kernel itself (interpret mode), at its
    full-f32 'kara_hp' precision: both sides are fp32, so the JAX fused
    parity bounds apply."""
    psi, data, scan, prb = make_inputs(GEOM, np.complex64)
    grad_p, minf_p = pallas_fused.grad_fused(
        jnp.asarray(psi), jnp.asarray(data), jnp.asarray(scan),
        jnp.asarray(prb), GEOM.ndet, model, precision="kara_hp")
    grad_p, minf_p = np.asarray(grad_p), float(minf_p)
    grad_t, minf_t = port_grad_fused(psi, data, scan, prb, GEOM, model)
    assert grad_t.dtype == np.complex64
    assert np.abs(grad_t - grad_p).max() <= 1e-4 * np.abs(grad_p).max()
    assert abs(minf_t - minf_p) <= 1e-5 * abs(minf_p)


def test_cpu_tensors_run_the_plain_version():
    """A CPU tensor runs grad_fused_reference and never the kernel; the
    precision tags of every tier are accepted and change nothing."""
    psi, data, scan, prb = map(to_torch, make_inputs(GEOM, np.complex64))
    before_kernel = fused.grad_fused.launches
    before_plain = fused.grad_fused_reference.launches
    g0, f0 = fused.grad_fused(psi, data, scan, prb, GEOM.ndet, "gaussian")
    g1, f1 = fused.grad_fused(psi, data, scan, prb, GEOM.ndet, "gaussian",
                              precision="kara_x3", adj_precision="bf16")
    assert fused.grad_fused.launches == before_kernel
    assert fused.grad_fused_reference.launches == before_plain + 2
    assert torch.equal(g0, g1) and float(f0) == float(f1)


def test_unsupported_arguments_raise():
    psi, data, scan, prb = map(to_torch, make_inputs(GEOM, np.complex64))
    with pytest.raises(NotImplementedError, match="base"):
        fused.grad_fused(psi, data, scan, prb, GEOM.ndet, "gaussian",
                         base=torch.zeros(GEOM.farplane_shape,
                                          dtype=torch.complex64))
    with pytest.raises(ValueError, match="unknown model"):
        fused.grad_fused(psi, data, scan, prb, GEOM.ndet, "laplace")
