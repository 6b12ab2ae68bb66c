"""The port's quality metrics, scan diagnostics and native scanprep copy
against the JAX package's.

The same numpy arrays (from seeds) go through both packages. The metrics
and diagnostics are host-side numpy on both sides, so they agree to
rounding (1e-12 relative) or exactly; the port's native library and its
numpy fallback agree exactly.
"""

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax import models as jmodels
from tikejax.native import scanprep as jscanprep
from tikejax_torch import models as tmodels
from tikejax_torch import native as tnative
from tikejax_torch.native import scanprep as tscanprep
from tikejax_torch.utils import geometry_from

GEOM = tikejax.Geometry(nz=40, n=52, nscan=30, ndet=24, nprb=16, ntheta=2)


def crand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def scan_grid(rng, g, n_bad=0):
    scan = np.stack([
        rng.uniform(0, g.nz - g.nprb + 1, (g.ntheta, g.nscan)),
        rng.uniform(0, g.n - g.nprb + 1, (g.ntheta, g.nscan)),
    ], -1).astype(np.float32)
    scan = np.minimum(scan, np.float32([g.nz - g.nprb, g.n - g.nprb]))
    for k in range(n_bad):
        scan[k % g.ntheta, k, k % 2] = -3.5 if k % 3 else 1e4
    return scan


@pytest.fixture
def numpy_fallback(monkeypatch):
    """Run the port's scanprep without its native library."""
    monkeypatch.setattr(tscanprep, "_lib", None)
    monkeypatch.setattr(tscanprep, "_tried", True)


def test_models_exports_mirror_jax():
    assert set(tmodels.__all__) == set(jmodels.__all__)
    assert set(tnative.__all__) == {"validate_scan", "overlap_counts_host",
                                    "have_native"}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_quality_metrics_match_jax(as_tensor):
    rng = np.random.default_rng(0)
    psi_true = crand(rng, (2, 48, 48))
    psi = (0.7 - 0.4j) * psi_true + 0.05 * crand(rng, psi_true.shape)
    prb_true = crand(rng, (2, 3, 16, 16))
    prb = (1.3 + 0.2j) * prb_true + 0.02 * crand(rng, prb_true.shape)
    wrap = torch.from_numpy if as_tensor else (lambda x: x)
    for name, a, b in (("relative_object_error", psi, psi_true),
                       ("relative_probe_error", prb, prb_true)):
        ref = getattr(jmodels, name)(a, b)
        got = getattr(tmodels, name)(wrap(a), wrap(b))
        assert isinstance(got, float) and 0 < got < 0.2
        assert abs(got - ref) <= 1e-12 * ref
    # A pure complex scale is no error; the border is excluded.
    assert tmodels.relative_probe_error(2j * prb_true, prb_true) < 1e-12
    edge = psi_true.copy()
    edge[..., :6, :] = 0
    assert tmodels.relative_object_error(edge, psi_true) < 1e-12
    assert tmodels.relative_object_error(edge, psi_true,
                                         border_frac=0.05) > 1e-3


@pytest.mark.parametrize("n_bad", [0, 4])
def test_scan_report_and_check_scan_match_jax(n_bad):
    rng = np.random.default_rng(1)
    scan = scan_grid(rng, GEOM, n_bad)
    g = geometry_from(GEOM)
    ref = jmodels.scan_report(scan, GEOM)
    got = tmodels.scan_report(scan, g)
    assert got == ref and got["n_out_of_bounds"] == n_bad
    assert got["coverage_max"] >= got["coverage_mean"] >= got["coverage_min"]
    if n_bad:
        for fn, geom in ((jmodels.check_scan, GEOM), (tmodels.check_scan, g)):
            with pytest.raises(ValueError, match=f"{n_bad} scan position"):
                fn(scan, geom)
    else:
        tmodels.check_scan(scan, g)
    with pytest.raises(ValueError, match="scan shape"):
        tmodels.scan_report(scan[:, :-1], g)


def test_native_copy_matches_jax_native_and_its_own_fallback(monkeypatch):
    """validate_scan and overlap_counts_host: the port's native library
    against the JAX package's, then against the port's numpy fallback."""
    rng = np.random.default_rng(2)
    scan = scan_grid(rng, GEOM, n_bad=3)
    assert tscanprep.have_native() == jscanprep.have_native()
    si_t, bad_t = tscanprep.validate_scan(scan, GEOM.nz, GEOM.n, GEOM.nprb)
    si_j, bad_j = jscanprep.validate_scan(scan, GEOM.nz, GEOM.n, GEOM.nprb)
    np.testing.assert_array_equal(si_t, si_j)
    assert bad_t == bad_j == 3 and si_t.dtype == np.int32
    c_t = tscanprep.overlap_counts_host(si_t[0], GEOM.nz, GEOM.n, GEOM.nprb)
    c_j = jscanprep.overlap_counts_host(si_j[0], GEOM.nz, GEOM.n, GEOM.nprb)
    np.testing.assert_array_equal(c_t, c_j)
    monkeypatch.setattr(tscanprep, "_lib", None)
    monkeypatch.setattr(tscanprep, "_tried", True)
    assert not tscanprep.have_native()
    si_f, bad_f = tscanprep.validate_scan(scan, GEOM.nz, GEOM.n, GEOM.nprb)
    np.testing.assert_array_equal(si_f, si_t)
    assert bad_f == bad_t
    np.testing.assert_array_equal(
        tscanprep.overlap_counts_host(si_f[0], GEOM.nz, GEOM.n, GEOM.nprb),
        c_t)


def test_diagnostics_on_the_numpy_fallback(numpy_fallback):
    rng = np.random.default_rng(3)
    scan = scan_grid(rng, GEOM, n_bad=2)
    assert not tnative.have_native()
    assert tmodels.scan_report(scan, geometry_from(GEOM)) == (
        jmodels.scan_report(scan, GEOM))


def test_native_library_is_built_outside_the_package():
    """The library lands in build/native/ at the root of the checkout,
    under a name carrying the source's hash; nothing is written beside the
    source."""
    if not tscanprep.have_native():
        pytest.skip("no C++ compiler: the numpy fallback is in use")
    lib = tscanprep._library()
    assert lib.exists() and lib.parent == tscanprep.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "native")
    beside = [p.name for p in tscanprep._SRC.parent.iterdir()
              if p.suffix in (".so", ".tmp")]
    assert beside == []


def test_overlap_counts_match_the_device_scatter():
    """The difference-array counts equal the oracle's scatter of all-ones
    patches (``ops.patches.overlap_counts``); masked and out-of-bounds
    positions count nothing."""
    from tikejax_torch.ops import patches

    rng = np.random.default_rng(4)
    scan = scan_grid(rng, GEOM)
    si, _ = tscanprep.validate_scan(scan, GEOM.nz, GEOM.n, GEOM.nprb)
    si[1, 4, 0] = -1
    host = np.stack([tscanprep.overlap_counts_host(si[t], GEOM.nz, GEOM.n,
                                                   GEOM.nprb)
                     for t in range(GEOM.ntheta)])
    dev = patches.overlap_counts(torch.from_numpy(si), GEOM.nz, GEOM.n,
                                 GEOM.nprb)
    np.testing.assert_array_equal(host, dev.numpy())
