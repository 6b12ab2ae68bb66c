"""The port's oracle operators against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages through
``tikejax_torch.utils.bridge``. The JAX side runs its 'xla' oracle path in
complex128 (the suite enables x64), so the two agree to rounding: 1e-10
relative for values, 1e-12 for the Hermitian pair identities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tikejax
from tikejax.models import likelihoods as jlik
from tikejax.models import simulate as jsim
from tikejax.ops import diffraction as jdiff
from tikejax.ops import fft as jfft
from tikejax.ops import patches as jpatch
from tikejax_torch.models import likelihoods as tlik
from tikejax_torch.models import simulate as tsim
from tikejax_torch.ops import diffraction as tdiff
from tikejax_torch.ops import fft as tfft
from tikejax_torch.ops import patches as tpatch
from tikejax_torch.utils import geometry_from, to_numpy, to_torch

GEOMS = [
    tikejax.Geometry(nz=40, n=37, nscan=11, ndet=24, nprb=16),  # odd, pad
    tikejax.Geometry(nz=32, n=32, nscan=9, ndet=16, nprb=16, ntheta=2,
                     nmodes=3),
]


def crand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def make_inputs(g, seed=0, sentinel=False):
    """psi, scan (float, floored offsets), prb, farplane in complex128;
    with ``sentinel`` the last position of the last angle is a masked
    dummy (scan row -1)."""
    rng = np.random.default_rng(seed)
    psi = crand(rng, g.psi_shape)
    prb = crand(rng, g.prb_shape)
    farp = crand(rng, g.farplane_shape)
    scan = np.stack([
        rng.uniform(0, g.nz - g.nprb + 1, (g.ntheta, g.nscan)),
        rng.uniform(0, g.n - g.nprb + 1, (g.ntheta, g.nscan)),
    ], -1)
    scan = np.minimum(scan, [g.nz - g.nprb, g.n - g.nprb])
    if sentinel:
        scan[-1, -1, 0] = -1.0
    return psi, scan, prb, farp


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def t(x):
    return to_torch(np.asarray(x))


def test_fft_pad_crop_match_jax():
    rng = np.random.default_rng(1)
    x = crand(rng, (2, 3, 10, 10))
    assert rel(jfft.fft2o(x), to_numpy(tfft.fft2o(t(x)))) < 1e-10
    assert rel(jfft.ifft2o(x), to_numpy(tfft.ifft2o(t(x)))) < 1e-10
    padded = tfft.pad_to_det(t(x), 16)
    np.testing.assert_array_equal(to_numpy(padded),
                                  np.asarray(jfft.pad_to_det(x, 16)))
    np.testing.assert_array_equal(to_numpy(tfft.crop_from_det(padded, 10)),
                                  x)


@pytest.mark.parametrize("g", GEOMS)
def test_patches_match_jax(g):
    psi, scan, prb, _ = make_inputs(g, sentinel=True)
    si_j = jpatch.scan_to_int(jnp.asarray(scan))
    si_t = tpatch.scan_to_int(t(scan))
    np.testing.assert_array_equal(to_numpy(si_t), np.asarray(si_j))
    assert si_t.dtype == torch.int32

    pj = jpatch.gather_patches(psi, si_j, g.nprb)
    pt = tpatch.gather_patches(t(psi), si_t, g.nprb)
    np.testing.assert_array_equal(to_numpy(pt), np.asarray(pj))
    assert rel(jpatch.scatter_patches_add(pj, si_j, g.nz, g.n),
               to_numpy(tpatch.scatter_patches_add(pt, si_t, g.nz,
                                                   g.n))) < 1e-10
    power = np.sum(np.abs(prb)**2, axis=1)
    assert rel(jpatch.illumination_map(si_j, power, g.nz, g.n),
               to_numpy(tpatch.illumination_map(si_t, t(power), g.nz,
                                                g.n))) < 1e-10
    np.testing.assert_array_equal(
        to_numpy(tpatch.overlap_counts(si_t, g.nz, g.n, g.nprb)),
        np.asarray(jpatch.overlap_counts(si_j, g.nz, g.n, g.nprb)))


def test_check_scan_in_bounds():
    g = GEOMS[0]
    _, scan, _, _ = make_inputs(g)
    tpatch.check_scan_in_bounds(t(scan), g.nz, g.n, g.nprb)
    scan[0, 0, 1] = g.n - g.nprb + 1
    with pytest.raises(ValueError, match="1 scan position"):
        tpatch.check_scan_in_bounds(t(scan), g.nz, g.n, g.nprb)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_likelihoods_match_jax(model):
    g = GEOMS[1]
    _, _, _, farp = make_inputs(g)
    rng = np.random.default_rng(2)
    data = np.abs(crand(rng, g.data_shape))**2
    data[0, 0, 0, :3] = -1.0  # negative counts are clamped by both
    minf_j, resid_j = jlik.get_model(model)
    minf_t, resid_t = tlik.get_model(model)
    assert rel(minf_j(farp, data), float(minf_t(t(farp), t(data)))) < 1e-10
    assert rel(resid_j(farp, data),
               to_numpy(resid_t(t(farp), t(data)))) < 1e-10
    assert rel(jlik.poisson_perfect_minf(data),
               float(tlik.poisson_perfect_minf(t(data)))) < 1e-10
    with pytest.raises(ValueError, match="unknown model"):
        tlik.get_model("laplace")


@pytest.mark.parametrize("g", GEOMS)
def test_oracle_operators_match_jax(g):
    psi, scan, prb, farp = make_inputs(g, sentinel=True)
    assert rel(jdiff.fwd_raw(psi, scan, prb, g.ndet),
               to_numpy(tdiff.fwd_raw(t(psi), t(scan), t(prb),
                                      g.ndet))) < 1e-10
    assert rel(jdiff.adj_raw(farp, scan, prb, g.nz, g.n),
               to_numpy(tdiff.adj_raw(t(farp), t(scan), t(prb), g.nz,
                                      g.n))) < 1e-10
    assert rel(jdiff.adj_probe_raw(farp, scan, psi, g.nprb),
               to_numpy(tdiff.adj_probe_raw(t(farp), t(scan), t(psi),
                                            g.nprb))) < 1e-10


@pytest.mark.parametrize("g", GEOMS)
def test_hermitian_pairs(g):
    psi, scan, prb, farp = make_inputs(g, sentinel=True)
    psi, scan, prb, farp = map(t, (psi, scan, prb, farp))
    op = tdiff.Ptycho(geometry_from(g))
    lhs = torch.vdot(op.fwd(psi, scan, prb).reshape(-1), farp.reshape(-1))
    rhs = torch.vdot(psi.reshape(-1), op.adj(farp, scan, prb).reshape(-1))
    rhs_p = torch.vdot(prb.reshape(-1),
                       op.adj_probe(farp, scan, psi).reshape(-1))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12
    assert abs(lhs - rhs_p) / abs(lhs) < 1e-12


def test_sentinel_position_contributes_nothing():
    g = GEOMS[0]
    psi, scan, prb, farp = make_inputs(g)
    dummy = np.array([[[-1.0, 0.0]]])
    scan_ext = np.concatenate([scan, dummy], axis=1)
    farp_ext = np.concatenate(
        [farp, crand(np.random.default_rng(3), (1, 1) + farp.shape[2:])],
        axis=1)
    f_ext = to_numpy(tdiff.fwd_raw(t(psi), t(scan_ext), t(prb), g.ndet))
    np.testing.assert_array_equal(np.abs(f_ext[:, -1]), 0.0)
    a_ref = tdiff.adj_raw(t(farp), t(scan), t(prb), g.nz, g.n)
    a_ext = tdiff.adj_raw(t(farp_ext), t(scan_ext), t(prb), g.nz, g.n)
    assert rel(to_numpy(a_ref), to_numpy(a_ext)) < 1e-12
    p_ref = tdiff.adj_probe_raw(t(farp), t(scan), t(psi), g.nprb)
    p_ext = tdiff.adj_probe_raw(t(farp_ext), t(scan_ext), t(psi), g.nprb)
    assert rel(to_numpy(p_ref), to_numpy(p_ext)) < 1e-12


def test_autograd_matches_conj_jax_grad():
    """PyTorch's gradient of a real loss through ``fwd`` is the conjugate
    of ``jax.grad`` through ``tikejax.ops.fwd`` (JAX's vjp is the
    unconjugated transpose; PyTorch's backward is A^H)."""
    g = GEOMS[1]
    psi, scan, prb, farp = make_inputs(g)

    def loss_j(ps, pr):
        r = jdiff.fwd(ps, jnp.asarray(scan), pr, g.ndet, "xla") - farp
        return 0.5 * jnp.sum(jnp.abs(r)**2)

    dpsi_j, dprb_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(psi),
                                                      jnp.asarray(prb))
    ps = t(psi).requires_grad_()
    pr = t(prb).requires_grad_()
    r = tdiff.fwd(ps, t(scan), pr, g.ndet, "xla") - t(farp)
    (0.5 * torch.sum(r.abs()**2)).backward()
    assert rel(np.conj(np.asarray(dpsi_j)), to_numpy(ps.grad)) < 1e-10
    assert rel(np.conj(np.asarray(dprb_j)), to_numpy(pr.grad)) < 1e-10


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_deterministic_simulation_matches_jax(dtype):
    """make_probe and raster_scan(jitter=0) involve no randomness. The scan
    is exact; the probe agrees to the last units of the working type's
    rounding (the two libraries' exp differ by an ulp)."""
    g = tikejax.Geometry(nz=50, n=45, nscan=13, ndet=24, nprb=20, ntheta=2,
                         nmodes=3)
    pj = np.asarray(jsim.make_probe(g.ntheta, g.nmodes, g.nprb,
                                    getattr(jnp, dtype)))
    pt = to_numpy(tsim.make_probe(g.ntheta, g.nmodes, g.nprb,
                                  getattr(torch, dtype)))
    assert pt.dtype == pj.dtype
    eps = np.finfo(pj.real.dtype).eps
    np.testing.assert_allclose(pt, pj, rtol=8 * eps, atol=8 * eps)
    sj = np.asarray(jsim.raster_scan(jax.random.PRNGKey(0), g, jitter=0))
    st = to_numpy(tsim.raster_scan(None, geometry_from(g), jitter=0))
    np.testing.assert_array_equal(st, sj)


def test_simulated_problem_is_consistent():
    """make_problem's data are the oracle intensities of its own object,
    probe and scan, and the scan is in bounds."""
    g = geometry_from(tikejax.Geometry(nz=48, n=48, nscan=16, ndet=24,
                                       nprb=16, nmodes=2))
    gen = torch.Generator().manual_seed(0)
    psi, scan, prb, data = tsim.make_problem(gen, g, dtype=torch.complex128)
    tpatch.check_scan_in_bounds(scan, g.nz, g.n, g.nprb)
    far = tdiff.fwd_raw(psi, scan, prb, g.ndet)
    assert rel(to_numpy(tlik.total_intensity(far)), to_numpy(data)) < 1e-12
    amp = psi.abs()
    assert 0.5 - 1e-9 <= float(amp.min()) and float(amp.max()) <= 1 + 1e-9
    noisy = tsim.make_problem(torch.Generator().manual_seed(0), g,
                              poisson_photons=1e4)[3]
    assert noisy.shape == data.shape and bool((noisy >= 0).all())


def test_kernel_resolution():
    """'auto' resolves with "on CUDA" in place of "on the TPU"; explicit
    choices pass through; unported operator kernels raise on every
    device instead of rerouting to 'xla'."""
    assert tdiff.resolve_kernel("auto", "cuda") == "fused_mp"
    assert tdiff.resolve_kernel("auto", "cpu") == "xla"
    assert tdiff.resolve_kernel_for_target("auto", 0.0, "cuda") == "fused_mx"
    assert tdiff.resolve_kernel_for_target("auto", 1e-6, "cuda") == "fused_hp"
    assert tdiff.resolve_kernel_for_target("auto", 1e-1, "cuda") == "fused"
    assert tdiff.resolve_kernel_for_target("auto", 1e-6, "cpu") == "xla"
    assert tdiff.resolve_kernel_for_target("fused", 1e-8, "cuda") == "fused"
    for k in ("fused", "fused_mp", "fused_hp", "fused_mx", "fused_hx",
              "fused_am"):
        assert tdiff._fused_precision(k) == jdiff._fused_precision(k)
        assert tdiff._fused_adj_precision(k) == jdiff._fused_adj_precision(k)
    g = GEOMS[0]
    psi, scan, prb, farp = map(t, make_inputs(g)[:4])
    for kernel in ("fused_mp", "fused_mx", "pallas"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdiff.fwd_raw(psi, scan, prb, g.ndet, kernel)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdiff.adj_raw(farp, scan, prb, g.nz, g.n, kernel)
    with pytest.raises(ValueError, match="unknown kernel"):
        tdiff.Ptycho(geometry_from(g), kernel="cufft")
