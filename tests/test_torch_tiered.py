"""The port's ``reconstruct`` against
``tikejax.solvers.reconstruct``, stage by stage.

Both packages get the same problem (made once by the JAX package's
``make_problem`` in complex128 at 96^2 / 64 positions / 32^2, handed over as
numpy arrays) and run the oracle path ('xla' for both split kernels, as the
JAX package picks off the TPU and the port off CUDA). The stage lists must
agree one for one: names, ``iters_run`` and the per-iteration residuals to
1e-8 relative. The final objects agree to 1e-5 of their scale: directions
in which the objective is flat (the global phase, unilluminated pixels)
are not held by the residual. The JAX results are computed once per module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax
from tikejax.models import make_problem
from tikejax.solvers import cg as jcg
from tikejax.solvers import reconstruct as jreconstruct
from tikejax_torch.ops import fused
from tikejax_torch.solvers import cg as tcg
from tikejax_torch.solvers import reconstruct, tiered
from tikejax_torch.utils import geometry_from, to_numpy, to_torch


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


GEOM = tikejax.Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)
# The L-BFGS refinement amplifies the two packages' rounding differences
# (FFT and reduction order, ~1e-16) as the residual falls: about 1e-9 at
# 3e-5 after five 12-iteration segments, 1e-7 at 1e-6. The L-BFGS cases
# therefore stop at 3e-5; the Dai-Yuan case runs to 1e-6 (1e-11 there).
BASE = dict(target_residual=3e-5, segment=12, max_segments=30,
            tiers=(("xla", 5e-3, 96),))
CASES = {
    "split-anderson-carry": dict(BASE),
    "split-plain": dict(BASE, accelerate=None),
    "split-no-carry": dict(BASE, segment_carry=False),
    "split-dy-deep": dict(BASE, direction="dy", target_residual=1e-6),
    "split-anderson2-ring": dict(BASE, accelerate="anderson:2",
                                 carry_lbfgs=True),
    "tiers": dict(target_residual=1e-4, method="tiers",
                  tiers=(("xla", 2e-3, 40), ("xla", 0.0, 96))),
}


@pytest.fixture(scope="module")
def problem():
    _, scan, prb, data = make_problem(jax.random.PRNGKey(3), GEOM,
                                      dtype=jnp.complex128)
    psi0 = np.ones(GEOM.psi_shape, np.complex128)
    return tuple(np.asarray(x) for x in (data, psi0, scan, prb))


@pytest.fixture(scope="module")
def jax_runs(problem):
    """JAX reconstructions, computed on first use and shared."""
    cache = {}

    def get(name, **extra):
        key = (name, tuple(sorted(extra.items())))
        if key not in cache:
            cache[key] = jreconstruct(*map(jnp.asarray, problem), GEOM,
                                      **CASES[name], **extra)
        return cache[key]

    return get


def port_run(problem, **kw):
    return reconstruct(*map(cpu, problem), geometry_from(GEOM), **kw)


def host(x):
    return to_numpy(x) if torch.is_tensor(x) else np.asarray(x)


def assert_same_stages(sj, st, tol=1e-8):
    """Stage lists of either package agree one for one."""
    assert [n for n, _ in st] == [n for n, _ in sj]
    for (name, mj), (_, mt) in zip(sj, st):
        k = int(mj["iters_run"])
        assert int(mt["iters_run"]) == k, name
        np.testing.assert_allclose(host(mt["residual"]), host(mj["residual"]),
                                   rtol=tol, atol=0, err_msg=name)


def assert_same_object(pj, pt):
    pj, pt = np.asarray(pj), to_numpy(pt)
    assert np.abs(pt - pj).max() <= 1e-5 * np.abs(pj).max()


def final_residual(stages):
    m = stages[-1][1]
    return float(m["residual"][max(int(m["iters_run"]) - 1, 0)])


@pytest.mark.parametrize("name", list(CASES))
def test_reconstruct_matches_jax(problem, jax_runs, name):
    pj, _, sj = jax_runs(name)
    pt, prb_t, st = port_run(problem, **CASES[name])
    assert_same_stages(sj, st)
    assert_same_object(pj, pt)
    np.testing.assert_array_equal(to_numpy(prb_t), problem[3])
    target = CASES[name]["target_residual"]
    assert final_residual(st) <= target
    if name.startswith("split"):
        # The segment that reached the target, then the one-deep
        # speculative segment, which exits after one iteration.
        assert st[0][0] == "xla" and len(st) >= 4
        assert all(n == "split:xla" for n, _ in st[1:])
        assert int(st[-1][1]["iters_run"]) == 1
        assert int(st[-2][1]["iters_run"]) < CASES[name]["segment"]


def test_floor_stop_matches_jax():
    """A problem whose refinement floors far above the target: both
    packages stop after floor_patience flat segments, not at the budget."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(11), GEOM,
                                      dtype=jnp.complex128)
    prob = tuple(np.asarray(x) for x in (
        data, np.ones(GEOM.psi_shape, np.complex128), scan, prb))
    kw = dict(BASE, accelerate=None)
    pj, _, sj = jreconstruct(*map(jnp.asarray, prob), GEOM, **kw)
    pt, _, st = port_run(prob, **kw)
    assert_same_stages(sj, st)
    assert final_residual(st) > 1e-3 and len(st) < 1 + kw["max_segments"]


@pytest.mark.parametrize("writer, reader", [
    ("jax", "port"), ("port", "port"), ("port", "jax")])
def test_checkpoint_resume_matches_jax(problem, jax_runs, monkeypatch,
                                       tmp_path, writer, reader):
    """Kill a checkpointed split run after stage 1 and two refinement
    segments, then re-issue the same call in either package: it resumes
    from the checkpoint (written by either package) and reproduces the
    remaining stages of the uninterrupted JAX run."""
    path = str(tmp_path / "split.ckpt.npz")
    name = "split-anderson-carry"
    kw = dict(CASES[name], checkpoint_path=path, checkpoint_every=1)
    _, _, s_ref = jax_runs(name)
    run_mod = jcg if writer == "jax" else tcg
    real_run, calls = run_mod.run, {"n": 0}

    def crashing_run(*a, **k):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("simulated crash")
        return real_run(*a, **k)

    monkeypatch.setattr(run_mod, "run", crashing_run)
    with pytest.raises(RuntimeError, match="simulated"):
        if writer == "jax":
            jreconstruct(*map(jnp.asarray, problem), GEOM, **kw)
        else:
            port_run(problem, **kw)
    monkeypatch.setattr(run_mod, "run", real_run)
    assert os.path.exists(path)
    if reader == "port":
        with pytest.raises(ValueError, match="DIFFERENT"):
            port_run(problem, **dict(kw, segment=16))
        _, _, s_res = port_run(problem, **kw)
    else:
        _, _, s_res = jreconstruct(*map(jnp.asarray, problem), GEOM, **kw)
    assert len(s_res) == len(s_ref) - 3
    assert_same_stages(s_ref[3:], s_res)
    assert not os.path.exists(path)


def test_frameless_safeguard_reproduces_the_reuse_safeguard(problem,
                                                            monkeypatch):
    """With a fused base tier, forcing the memory-bound safeguard (both
    candidates' objectives from minf_fused, the base as split views)
    reproduces the farplane-reusing one: the same choices, so the same
    stages; it launches minf_fused twice per Anderson step and freezes a
    base every segment instead of reusing the winner's farplane."""
    kw = dict(BASE, base_kernel="fused_hp", fast_kernel="fused",
              tiers=(("fused", 5e-3, 64),))
    f0 = fused.fwd_reference.launches
    _, _, s_reuse = port_run(problem, **kw)
    reuse_fwd = fused.fwd_reference.launches - f0
    monkeypatch.setattr(tiered, "_SAFEGUARD_FRAMELESS_BYTES", 0)
    f0, m0 = fused.fwd_reference.launches, fused.minf_fused_reference.launches
    _, _, s_frameless = port_run(problem, **kw)
    n_split = len(s_frameless) - 1
    assert n_split >= 3 and [n for n, _ in s_reuse][1:] == (
        ["split:fused"] * n_split)
    assert_same_stages(s_reuse, s_frameless, tol=1e-12)
    assert fused.minf_fused_reference.launches - m0 == 2 * (n_split - 1)
    assert fused.fwd_reference.launches - f0 == n_split
    assert reuse_fwd == 2 * n_split  # two freezes, then two per mix
    assert final_residual(s_frameless) <= BASE["target_residual"]


@pytest.mark.parametrize("kw, error, match", [
    (dict(mesh=object()), ValueError, "DeviceMesh")], ids=["mesh"])
def test_unported_arguments_raise(problem, kw, error, match):
    """``mesh=`` is ported (``tests/test_torch_sharding.py`` runs it on
    gloo ranks) and takes only a DeviceMesh. (The slab fields are ported
    as a contract: ``tests/test_torch_large.py``.)"""
    with pytest.raises(error, match=match):
        port_run(problem, **BASE, **kw)


def test_invalid_arguments_raise(problem, tmp_path):
    for kw, match in [
            (dict(target_residual=0.0), "target_residual"),
            (dict(method="bogus"), "method"),
            (dict(accelerate="nesterov"), "accelerate"),
            (dict(accelerate="anderson:9"), "accelerate"),
            (dict(method="tiers", checkpoint_path=str(tmp_path / "c")),
             "split"),
            (dict(checkpoint_path=str(tmp_path / "c"), checkpoint_every=0),
             "checkpoint_every")]:
        with pytest.raises(ValueError, match=match):
            port_run(problem, **dict(BASE, **kw))


def test_default_kernels_follow_the_device(problem, monkeypatch):
    """Off CUDA the split kernels default to the oracle 'xla' (the JAX
    package's off-TPU choice); tensors on CUDA would get 'fused' and
    'fused_hp'."""
    seen = []
    real_run = tcg.run

    def spy(*a, **k):
        opts = a[5] if len(a) > 5 else k.get("options")
        seen.append(opts.kernel)
        return real_run(*a, **k)

    monkeypatch.setattr(tcg, "run", spy)
    port_run(problem, **dict(BASE, target_residual=1e-4, max_segments=2))
    assert set(seen) == {"xla"}
    assert torch.device("cpu").type != "cuda"


# -- more than one angle and more than one mode -----------------------------

GEOM2 = tikejax.Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=16, ntheta=2,
                         nmodes=2)


@pytest.mark.parametrize("kw", [
    dict(BASE, target_residual=1e-4, direction="dy"),
    dict(target_residual=1e-3, method="tiers",
         tiers=(("xla", 1e-2, 40), ("xla", 0.0, 96))),
], ids=["split", "tiers"])
def test_two_angles_two_modes_reconstruct_matches_jax(kw):
    """reconstruct at ntheta = 2, nmodes = 2 in float64: the split
    refinement (Anderson, carried state) and the tier schedule, stage for
    stage with the JAX package (Dai-Yuan: see the note above BASE)."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(5), GEOM2,
                                      dtype=jnp.complex128)
    problem = tuple(np.asarray(x) for x in (
        data, np.ones(GEOM2.psi_shape, np.complex128), scan, prb))
    pj, _, sj = jreconstruct(*map(jnp.asarray, problem), GEOM2, **kw)
    pt, prb_t, st = reconstruct(*map(cpu, problem), geometry_from(GEOM2),
                                **kw)
    assert_same_stages(sj, st)
    assert_same_object(pj, pt)
    np.testing.assert_array_equal(to_numpy(prb_t), problem[3])
    assert final_residual(st) <= kw["target_residual"]
    assert len(st) >= (4 if "method" not in kw else 2)
