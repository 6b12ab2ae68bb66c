"""The port's ``fwd``, ``minf_fused``, ``grad_fused(base=)``,
``grad_prb_fused``, ``adj`` and ``adj_probe`` (their plain paths on the
CPU) against the JAX package: the oracle operators in complex128 at 1e-10,
and the Pallas kernels of ``pallas_fused`` in interpret mode in complex64 at
their full-f32 'kara_hp' precision, where the tolerances are the JAX
package's fused parity bounds (farplane, gradients and adjoints 1e-4 of
their scale, objective 1e-5 relative). ntheta = 2 and nmodes = 2, odd
object sides, and the last position of the last angle is a masked dummy
(scan row < 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax.models import likelihoods as jlik
from tikejax.ops import diffraction as jdiff
from tikejax.ops import pallas_fused
from tikejax_torch.ops import diffraction as tdiff
from tikejax_torch.ops import fused
from tikejax_torch.utils import to_numpy, to_torch


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


GEOM = tikejax.Geometry(nz=40, n=37, nscan=9, ndet=24, nprb=16, ntheta=2,
                        nmodes=2)


def make_inputs(g, dtype, seed=1):
    """psi, data, int scan, prb and a base farplane; the data are
    intensities of another object, so objectives and gradients are O(1)."""
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
    base = 0.5 * far.astype(dtype)
    scan[-1, -1, 0] = -1
    return psi, data, scan, prb, base


def jax_far(psi, scan, prb, base, g):
    """The JAX oracle farplane (+ base); the masked position's frame is
    the zero patch's (plus the base)."""
    far = np.asarray(jdiff.fwd_raw(psi, scan.astype(np.float64), prb,
                                   g.ndet))
    return far if base is None else far + base


def valid_minf(model, far, data, scan):
    minf_fn, _ = jlik.get_model(model)
    valid = scan[..., 0] >= 0
    return float(minf_fn(far[valid][None], data[valid][None]))


@pytest.mark.parametrize("with_base", [False, True])
def test_fwd_plain_matches_jax_oracle(with_base):
    psi, _, scan, prb, base = make_inputs(GEOM, np.complex128)
    base = base if with_base else None
    ref = jax_far(psi, scan, prb, base, GEOM)
    out = fused.fwd(cpu(psi), cpu(scan), cpu(prb), GEOM.ndet,
                    base=None if base is None else cpu(base))
    assert out.dtype == torch.complex128 and out.shape == GEOM.farplane_shape
    assert np.abs(to_numpy(out) - ref).max() < 1e-10 * np.abs(ref).max()
    re, im = fused.fwd(cpu(psi), cpu(scan), cpu(prb),
                       GEOM.ndet, split_out=True,
                       base=None if base is None else cpu(base))
    np.testing.assert_array_equal(to_numpy(re) + 1j * to_numpy(im),
                                  to_numpy(out))


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_minf_plain_matches_jax_oracle(model, with_base):
    psi, data, scan, prb, base = make_inputs(GEOM, np.complex128)
    base = base if with_base else None
    ref = valid_minf(model, jax_far(psi, scan, prb, base, GEOM), data, scan)
    got = float(fused.minf_fused(
        cpu(psi), cpu(data), cpu(scan), cpu(prb),
        GEOM.ndet, model, base=None if base is None else cpu(base)))
    assert abs(got - ref) < 1e-10 * abs(ref)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_grad_fused_base_plain_matches_jax_oracle(model):
    """grad_fused(base=) = G^H(factor(G psi + base)) and its objective."""
    psi, data, scan, prb, base = make_inputs(GEOM, np.complex128)
    far = jax_far(psi, scan, prb, base, GEOM)
    _, resid_fn = jlik.get_model(model)
    grad_j = np.asarray(jdiff.adj_raw(resid_fn(far, data),
                                      scan.astype(np.float64), prb, GEOM.nz,
                                      GEOM.n))
    grad_t, minf_t = fused.grad_fused(
        cpu(psi), cpu(data), cpu(scan), cpu(prb),
        GEOM.ndet, model, base=cpu(base))
    grad_t = to_numpy(grad_t)
    assert np.abs(grad_t - grad_j).max() < 1e-10 * np.abs(grad_j).max()
    ref = valid_minf(model, far, data, scan)
    assert abs(float(minf_t) - ref) < 1e-10 * abs(ref)


@pytest.mark.parametrize("split_out", [False, True])
@pytest.mark.parametrize("with_base", [False, True])
def test_fwd_plain_matches_pallas_kernel(with_base, split_out):
    psi, _, scan, prb, base = make_inputs(GEOM, np.complex64)
    base = base if with_base else None
    ref = np.asarray(pallas_fused.fwd(
        jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(prb), GEOM.ndet,
        precision="kara_hp",
        base=None if base is None else jnp.asarray(base)))
    out = fused.fwd(cpu(psi), cpu(scan), cpu(prb), GEOM.ndet,
                    base=None if base is None else cpu(base),
                    split_out=split_out)
    out = (to_numpy(out[0]) + 1j * to_numpy(out[1]) if split_out
           else to_numpy(out))
    assert out.dtype == np.complex64
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_minf_plain_matches_pallas_kernel(model, with_base):
    psi, data, scan, prb, base = make_inputs(GEOM, np.complex64)
    base = base if with_base else None
    ref = float(pallas_fused.minf_fused(
        jnp.asarray(psi), jnp.asarray(data), jnp.asarray(scan),
        jnp.asarray(prb), GEOM.ndet, model, precision="kara_hp",
        base=None if base is None else jnp.asarray(base)))
    got = fused.minf_fused(
        cpu(psi), cpu(data), cpu(scan), cpu(prb),
        GEOM.ndet, model, base=None if base is None else cpu(base))
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= 1e-5 * abs(ref)


def test_grad_fused_base_plain_matches_pallas_kernel():
    psi, data, scan, prb, base = make_inputs(GEOM, np.complex64)
    grad_p, minf_p = pallas_fused.grad_fused(
        jnp.asarray(psi), jnp.asarray(data), jnp.asarray(scan),
        jnp.asarray(prb), GEOM.ndet, "gaussian", precision="kara_hp",
        base=jnp.asarray(base))
    grad_p, minf_p = np.asarray(grad_p), float(minf_p)
    grad_t, minf_t = fused.grad_fused(
        cpu(psi), cpu(data), cpu(scan), cpu(prb),
        GEOM.ndet, "gaussian", base=cpu(base))
    assert np.abs(to_numpy(grad_t) - grad_p).max() <= (
        1e-4 * np.abs(grad_p).max())
    assert abs(float(minf_t) - minf_p) <= 1e-5 * abs(minf_p)


def test_base_forms_agree_and_cpu_runs_the_plain_versions():
    """A complex base and its view_as_real halves give the same results;
    CPU tensors never count a kernel launch."""
    psi, data, scan, prb, base = map(cpu,
                                     make_inputs(GEOM, np.complex64))
    args = (psi, data, scan, prb, GEOM.ndet, "gaussian")
    counters = [fused.grad_fused, fused.minf_fused, fused.fwd]
    plain = [fused.grad_fused_reference, fused.minf_fused_reference,
             fused.fwd_reference]
    kernel_before = [f.launches for f in counters]
    plain_before = [f.launches for f in plain]
    forms = [base, torch.view_as_real(base).unbind(-1)]
    grads = [fused.grad_fused(*args, base=b) for b in forms]
    minfs = [fused.minf_fused(*args, base=b) for b in forms]
    fars = [fused.fwd(psi, scan, prb, GEOM.ndet, base=b) for b in forms]
    assert torch.equal(grads[1][0], grads[0][0])
    assert float(grads[1][1]) == float(grads[0][1])
    assert float(minfs[1]) == float(minfs[0])
    assert torch.equal(fars[1], fars[0])
    assert fused._base_complex(forms[1]).data_ptr() == base.data_ptr()
    assert [f.launches for f in counters] == kernel_before
    assert [f.launches - b for f, b in zip(plain, plain_before)] == [2] * 3


@pytest.mark.parametrize("pair", ["separate planes", "swapped halves"])
def test_base_pair_that_is_not_one_complex_tensor_raises(pair):
    """An (re, im) pair is read only as the view_as_real halves of one
    complex tensor, on the CPU as on the card."""
    psi, data, scan, prb, base = map(cpu,
                                     make_inputs(GEOM, np.complex64))
    re, im = torch.view_as_real(base).unbind(-1)
    bad = ((base.real.clone(), base.imag.clone())
           if pair == "separate planes" else (im, re))
    with pytest.raises(ValueError, match="view_as_real"):
        fused.grad_fused(psi, data, scan, prb, GEOM.ndet, "gaussian",
                         base=bad)
    with pytest.raises(ValueError, match="view_as_real"):
        fused.minf_fused(psi, data, scan, prb, GEOM.ndet, "gaussian",
                         base=bad)
    with pytest.raises(ValueError, match="view_as_real"):
        fused.fwd(psi, scan, prb, GEOM.ndet, base=bad)


# -- the joint-recovery and streaming kernels: grad_prb_fused, adj,
# adj_probe ------------------------------------------------------------------

def farplane_for(g, dtype, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(g.farplane_shape)
            + 1j * rng.standard_normal(g.farplane_shape)).astype(dtype)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_grad_prb_fused_plain_matches_jax_oracle(model):
    """grad_prb_fused = G_prb^H(factor(G psi)) over the unmasked positions,
    and its objective, against the JAX oracle's adj_probe_raw."""
    psi, data, scan, prb, _ = make_inputs(GEOM, np.complex128)
    far = jax_far(psi, scan, prb, None, GEOM)
    _, resid_fn = jlik.get_model(model)
    grad_j = np.asarray(jdiff.adj_probe_raw(resid_fn(far, data),
                                            scan.astype(np.float64), psi,
                                            GEOM.nprb, "xla"))
    grad_t, minf_t = fused.grad_prb_fused(
        cpu(psi), cpu(data), cpu(scan), cpu(prb), GEOM.ndet, model)
    assert grad_t.dtype == torch.complex128
    assert rel(to_numpy(grad_t), grad_j) < 1e-10
    ref = valid_minf(model, far, data, scan)
    assert abs(float(minf_t) - ref) < 1e-10 * abs(ref)


def test_adjoints_plain_match_jax_oracle():
    psi, _, scan, prb, _ = make_inputs(GEOM, np.complex128)
    far = farplane_for(GEOM, np.complex128)
    sc = scan.astype(np.float64)
    a_t = fused.adj(cpu(far), cpu(scan), cpu(prb), GEOM.nz, GEOM.n)
    p_t = fused.adj_probe(cpu(far), cpu(scan), cpu(psi), GEOM.nprb)
    assert a_t.dtype == p_t.dtype == torch.complex128
    assert rel(to_numpy(a_t), jdiff.adj_raw(far, sc, prb, GEOM.nz, GEOM.n,
                                            "xla")) < 1e-10
    assert rel(to_numpy(p_t), jdiff.adj_probe_raw(far, sc, psi, GEOM.nprb,
                                                  "xla")) < 1e-10


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_grad_prb_fused_plain_matches_pallas_kernel(model):
    psi, data, scan, prb, _ = make_inputs(GEOM, np.complex64)
    grad_p, minf_p = pallas_fused.grad_prb_fused(
        jnp.asarray(psi), jnp.asarray(data), jnp.asarray(scan),
        jnp.asarray(prb), GEOM.ndet, model, precision="kara_hp")
    grad_t, minf_t = fused.grad_prb_fused(
        cpu(psi), cpu(data), cpu(scan), cpu(prb), GEOM.ndet, model)
    assert grad_t.dtype == torch.complex64 and minf_t.dtype == torch.float32
    assert rel(to_numpy(grad_t), grad_p) <= 1e-4
    assert abs(float(minf_t) - float(minf_p)) <= 1e-5 * abs(float(minf_p))


def test_adjoints_plain_match_pallas_kernels():
    psi, _, scan, prb, _ = make_inputs(GEOM, np.complex64)
    far = farplane_for(GEOM, np.complex64)
    a_p = pallas_fused.adj(jnp.asarray(far), jnp.asarray(scan),
                           jnp.asarray(prb), GEOM.nz, GEOM.n,
                           precision="kara_hp")
    p_p = pallas_fused.adj_probe(jnp.asarray(far), jnp.asarray(scan),
                                 jnp.asarray(psi), GEOM.nprb,
                                 precision="kara_hp")
    a_t = fused.adj(cpu(far), cpu(scan), cpu(prb), GEOM.nz, GEOM.n)
    p_t = fused.adj_probe(cpu(far), cpu(scan), cpu(psi), GEOM.nprb)
    assert a_t.dtype == p_t.dtype == torch.complex64
    assert rel(to_numpy(a_t), a_p) <= 1e-4
    assert rel(to_numpy(p_t), p_p) <= 1e-4


def test_new_kernels_on_cpu_run_their_plain_versions():
    """CPU tensors go to grad_prb_fused_reference / adj_reference /
    adj_probe_reference and never count a kernel launch; so do the fused
    tiers' operator-level adjoints, which now run fused.adj / adj_probe."""
    psi, data, scan, prb, _ = map(cpu, make_inputs(GEOM, np.complex64))
    far = cpu(farplane_for(GEOM, np.complex64))
    kernels = [fused.grad_prb_fused, fused.adj, fused.adj_probe]
    plain = [fused.grad_prb_fused_reference, fused.adj_reference,
             fused.adj_probe_reference]
    k0, p0 = [f.launches for f in kernels], [f.launches for f in plain]
    fused.grad_prb_fused(psi, data, scan, prb, GEOM.ndet, "gaussian",
                         precision="kara_x3", adj_precision="bf16")
    a = tdiff.adj_raw(far, scan, prb, GEOM.nz, GEOM.n, "fused_mx")
    p = tdiff.adj_probe_raw(far, scan, psi, GEOM.nprb, "fused")
    assert [f.launches for f in kernels] == k0
    assert [f.launches - b for f, b in zip(plain, p0)] == [1, 1, 1]
    torch.testing.assert_close(a, tdiff.adj_raw(far, scan, prb, GEOM.nz,
                                                GEOM.n), rtol=0, atol=0)
    torch.testing.assert_close(p, tdiff.adj_probe_raw(far, scan, psi,
                                                      GEOM.nprb),
                               rtol=0, atol=0)
