"""Joint object+probe recovery in the port against the JAX package:
``solvers.run(recover_prb=True)`` and ``solvers.reconstruct(recover_prb=
True)`` with its joint chains and probe refreshes.

Both packages get the same problem, made once by the JAX package's
``make_problem`` in complex128, with the probe perturbed by complex Gaussian
noise at 3% of its maximum (numpy seed). On the oracle path the two run the
same arithmetic in float64, so the joint trajectories agree to 1e-8:
per-iteration objective, residual, both steps and the returned probe. The
joint iteration is chaotic in the directions the objective leaves flat
(the object/probe scale), so rounding differences of 1e-16 grow ~1.3x an
iteration: the runs compared here stay short (16 joint iterations;
``reconstruct`` cases whose joint stages total under 50). The refresh logic
of ``reconstruct``, which needs hundreds of joint iterations to reach, is
compared on a scripted solver that both packages' ``reconstruct`` call
in place of ``cg.run``.
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
from tikejax.solvers import tiered as jtiered
from tikejax_torch.ops import fused
from tikejax_torch.solvers import cg as tcg
from tikejax_torch.solvers import reconstruct, tiered
from tikejax_torch.utils import checkpoint as tck
from tikejax_torch.utils import geometry_from, to_numpy, to_torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu(x):
    """The array as a CPU tensor: the bridge's default device is the card."""
    return to_torch(x, device="cpu")


GEOM = tikejax.Geometry(nz=64, n=64, nscan=16, ndet=32, nprb=24)
DEEP = tikejax.Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)
ITERS = 16


def perturbed_problem(g, key, seed):
    """(data, psi0 = ones, scan, perturbed probe, true probe), numpy."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(key), g,
                                      dtype=jnp.complex128)
    prb = np.asarray(prb)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(prb.shape) + 1j * rng.standard_normal(
        prb.shape)
    prb0 = prb + 0.03 * np.abs(prb).max() * noise
    return (np.asarray(data), np.ones(g.psi_shape, np.complex128),
            np.asarray(scan), prb0, prb)


@pytest.fixture(scope="module")
def problem():
    return perturbed_problem(GEOM, 0, 7)


@pytest.fixture(scope="module")
def deep_problem():
    return perturbed_problem(DEEP, 3, 5)


def run_both(problem, jax_kw, port_kw=None):
    data, p0, scan, prb0, _ = problem
    pj, prj, mj = jcg.run(*map(jnp.asarray, (data, p0, scan, prb0)), GEOM,
                          **jax_kw)
    pt, prt, mt = tcg.run(*map(cpu, (data, p0, scan, prb0)),
                          geometry_from(GEOM), **(port_kw or jax_kw))
    skip = ("cg_state",)
    return ((np.asarray(pj), np.asarray(prj),
             {k: np.asarray(v) for k, v in mj.items() if k not in skip}),
            (to_numpy(pt), to_numpy(prt),
             {k: (to_numpy(v) if torch.is_tensor(v) else v)
              for k, v in mt.items() if k not in skip}), mj, mt)


def assert_same_joint_trajectory(jax_out, port_out, tol):
    (pj, prj, mj), (pt, prt, mt) = jax_out, port_out
    n = int(mj["iters_run"])
    assert int(mt["iters_run"]) == n
    for key in ("gamma", "gamma_prb"):
        np.testing.assert_array_equal(mt[key][:n] == 0, mj[key][:n] == 0)
    for key in ("minf", "residual", "gamma", "gamma_prb", "grad_norm"):
        np.testing.assert_allclose(mt[key], mj[key], rtol=tol, atol=0,
                                   err_msg=key)
    assert np.abs(prt - prj).max() <= tol * np.abs(prj).max()
    assert np.abs(pt - pj).max() <= tol * np.abs(pj).max()


@pytest.mark.parametrize("kw", [
    dict(),                                            # 'auto' -> interp
    dict(model="poisson"),
    dict(linesearch="backtracking", precondition="max"),
    dict(precondition="none", step_policy="track"),
], ids=["gaussian", "poisson", "backtracking-max", "none-track"])
def test_joint_run_matches_jax(problem, kw):
    kw = dict(piter=ITERS, kernel="xla", recover_prb=True, **kw)
    jax_out, port_out, _, _ = run_both(problem, kw)
    assert_same_joint_trajectory(jax_out, port_out, tol=1e-8)
    _, prt, mt = port_out
    assert np.count_nonzero(mt["gamma_prb"]) > ITERS // 2  # the probe moved
    assert not np.allclose(prt, problem[3])


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_fused_joint_body_matches_jax(problem, model):
    """The fused tiers' joint body (grad_fused, grad_prb_fused and one
    minf_fused pass per candidate of both line searches; their plain
    versions here, in complex128) against JAX's oracle body, whose line
    search evaluates the same candidates from quadratic statistics."""
    before = [fused.grad_fused_reference.launches,
              fused.grad_prb_fused_reference.launches,
              fused.minf_fused_reference.launches]
    jax_out, port_out, _, _ = run_both(
        problem, dict(piter=ITERS, kernel="xla", recover_prb=True,
                      linesearch="backtracking", model=model),
        dict(piter=ITERS, kernel="fused_mx", recover_prb=True, model=model))
    assert_same_joint_trajectory(jax_out, port_out, tol=1e-8)
    mt = port_out[2]
    grads, grads_prb, candidates = (
        f.launches - b for f, b in zip(
            [fused.grad_fused_reference, fused.grad_prb_fused_reference,
             fused.minf_fused_reference], before))
    assert grads == grads_prb == ITERS
    assert candidates == mt["evaluations"] - 2 * ITERS >= 2 * ITERS


def test_joint_carry_state_is_the_objects(problem):
    """Under recover_prb the carried state is the object's (d, g, gamma,
    gamma0), as in the JAX package."""
    kw = dict(piter=8, kernel="xla", recover_prb=True, carry_state=True)
    _, _, mj, mt = run_both(problem, kw)
    sj, st = mj["cg_state"], mt["cg_state"]
    assert len(st) == len(sj) == 4
    for a, b in zip(sj, st):
        np.testing.assert_allclose(to_numpy(b), np.asarray(a), rtol=1e-8,
                                   atol=1e-12)


def test_joint_validation(problem):
    data, psi0, scan, prb0, _ = map(cpu, problem)
    g = geometry_from(GEOM)
    f_base = torch.zeros(g.farplane_shape, dtype=torch.complex128)
    with pytest.raises(ValueError, match="joint probe recovery"):
        tcg.run(data, psi0, scan, prb0, g, piter=2, kernel="xla",
                recover_prb=True, f_base=f_base)
    with pytest.raises(ValueError, match="joint probe recovery"):
        jcg.run(*map(jnp.asarray, problem[:4]), GEOM, piter=2, kernel="xla",
                recover_prb=True, f_base=jnp.zeros(GEOM.farplane_shape,
                                                   jnp.complex128))


def test_joint_stall_needs_both_steps_to_fail(problem):
    """stop_on_stall counts an iteration as failed only when neither the
    object nor the probe moved, as in the JAX package."""
    kw = dict(piter=ITERS, kernel="xla", recover_prb=True, step0=1e6,
              max_halvings=0, adaptive_step=False)
    jax_out, port_out, _, _ = run_both(problem, kw)
    n = int(jax_out[2]["iters_run"])
    assert n == int(port_out[2]["iters_run"]) == 2
    np.testing.assert_array_equal(port_out[0], problem[1])
    np.testing.assert_array_equal(port_out[1], problem[3])


# -- reconstruct(recover_prb=True) -------------------------------------------

DEEP_KW = dict(target_residual=2e-3, segment=12, max_segments=12,
               tiers=(("xla", 5e-3, 96),), direction="dy")


def host(x):
    return to_numpy(x) if torch.is_tensor(x) else np.asarray(x)


def assert_same_stages(sj, st, tol=1e-8, rename=None):
    rename = rename or {}
    assert [rename.get(n, n) for n, _ in st] == [n for n, _ in sj]
    for (name, mj), (_, mt) in zip(sj, st):
        assert int(mt["iters_run"]) == int(mj["iters_run"]), name
        np.testing.assert_allclose(host(mt["residual"]), host(mj["residual"]),
                                   rtol=tol, atol=0, err_msg=name)


@pytest.fixture(scope="module")
def jax_deep(deep_problem):
    return jreconstruct(*map(jnp.asarray, deep_problem[:4]), DEEP,
                        recover_prb=True, **DEEP_KW)


def test_joint_reconstruct_matches_jax(deep_problem, jax_deep):
    """Joint stage 1 on the fast tier, the joint escalation chain (the
    target is below the fast tier's floor), then the refinement with the
    probe frozen: the same stages, lengths and residuals."""
    pj, prj, sj = jax_deep
    pt, prt, st = reconstruct(*map(cpu, deep_problem[:4]),
                              geometry_from(DEEP), recover_prb=True,
                              **DEEP_KW)
    assert_same_stages(sj, st)
    names = [n for n, _ in st]
    assert names[:5] == ["xla:joint"] * 5 and names[5:] == (
        ["split:xla"] * (len(names) - 5))
    np.testing.assert_allclose(to_numpy(prt), np.asarray(prj), rtol=0,
                               atol=1e-8 * np.abs(prj).max())
    prb_true = deep_problem[4]
    assert (np.abs(to_numpy(prt) - prb_true).max()
            < np.abs(deep_problem[3] - prb_true).max())


def test_joint_kernel_runs_the_fused_joint_body(deep_problem):
    """joint_kernel picks the escalation chain's kernel: on a fused tier
    the chain runs grad_prb_fused (here its plain version) once per joint
    iteration, and follows the JAX package's oracle chain."""
    kw = dict(DEEP_KW, linesearch="interp")
    _, _, sj = jreconstruct(*map(jnp.asarray, deep_problem[:4]), DEEP,
                            recover_prb=True, **kw)
    before = fused.grad_prb_fused_reference.launches
    _, _, st = reconstruct(*map(cpu, deep_problem[:4]), geometry_from(DEEP),
                           recover_prb=True, joint_kernel="fused_hp", **kw)
    assert_same_stages(sj, st, rename={"fused_hp:joint": "xla:joint"})
    chain = [mm for n, mm in st if n == "fused_hp:joint"]
    assert len(chain) == 4
    assert (fused.grad_prb_fused_reference.launches - before
            == sum(int(mm["iters_run"]) for mm in chain))


@pytest.mark.parametrize("seed", range(4))
def test_aitken_floor_prediction_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sequences = [list(1e-4 * (0.3 + 0.45**np.arange(k)) + 1e-7 * rng.random(k))
                 for k in (3, 4, 6)]
    sequences += [list(rng.random(5) * 1e-4) for _ in range(20)]
    sequences += [[4e-5, 3e-5, 2.5e-5, 2.2e-5], [1e-5, 2e-5, 1e-5, 5e-6]]
    for res in sequences:
        for target in (1e-6, 2e-5, 1e-4):
            assert (tiered._probe_floor_predicted(res, target)
                    == jtiered._probe_floor_predicted(res, target))
        if len(res) >= 3:
            assert (tiered._aitken_limit(*res[-3:])
                    == jtiered._aitken_limit(*res[-3:]))
    assert tiered._probe_floor_predicted(
        list(1e-4 * (0.3 + 0.45**np.arange(5))), 1e-6)


# -- the refresh logic, on a scripted solver --------------------------------

class ScriptedSolver:
    """Stands in for ``cg.run`` in both packages: a residual that a joint
    iteration lowers together with the floor the probe error sets, and that
    an object-only iteration contracts toward that floor. ``split`` is the
    per-iteration contraction of the object-only segments: 0.9 makes a
    near-geometric approach (the Aitken refresh fires), 0.9999 a flat one
    (the flat counter fires)."""

    def __init__(self, split):
        self.split = split
        self.state = {"r": 2e-2, "floor": 1e-3}
        self.calls = 0
        self.crash_at = None

    def __call__(self, data, psi, scan, prb, g, options, f_base=None,
                 cg_init=None):
        self.calls += 1
        if self.calls == self.crash_at:
            raise RuntimeError("simulated crash")
        st, res = self.state, np.zeros(options.piter)
        ran = 0
        while ran < options.piter and not (
                ran > 0 and res[ran - 1] <= options.target_residual):
            if options.recover_prb:
                st["floor"] *= 0.995
                st["r"] = st["floor"] + 0.98 * (st["r"] - st["floor"])
            else:
                st["r"] = st["floor"] + self.split * (st["r"] - st["floor"])
            res[ran] = st["r"]
            ran += 1
        return psi, prb, {"residual": res, "iters_run": np.int32(ran)}


SCRIPT_KW = dict(target_residual=2e-6, segment=12, max_segments=40,
                 tiers=(("xla", 5e-3, 96),), accelerate=None,
                 segment_carry=False)


def scripted_run(package, solver, monkeypatch, deep_problem, **kw):
    if package == "jax":
        monkeypatch.setattr(jcg, "run", solver)
        return jreconstruct(*map(jnp.asarray, deep_problem[:4]), DEEP,
                            recover_prb=True, **SCRIPT_KW, **kw)
    monkeypatch.setattr(tcg, "run", solver)
    return reconstruct(*map(cpu, deep_problem[:4]), geometry_from(DEEP),
                       recover_prb=True, **SCRIPT_KW, **kw)


@pytest.mark.parametrize("split", [0.9, 0.9999], ids=["aitken", "flat"])
def test_probe_refresh_matches_jax(deep_problem, monkeypatch, split):
    """The same refreshes fire at the same segments in both packages: early
    by the Aitken prediction, or by the flat counter."""
    _, _, sj = scripted_run("jax", ScriptedSolver(split), monkeypatch,
                            deep_problem)
    _, _, st = scripted_run("port", ScriptedSolver(split), monkeypatch,
                            deep_problem)
    assert_same_stages(sj, st, tol=0)
    names = [n for n, _ in st]
    first = names.index("split:xla")
    refreshes = [i for i in range(first, len(names))
                 if names[i] == "xla:joint" and names[i - 1] != "xla:joint"]
    assert len(refreshes) == 2
    # Aitken fires once four segment residuals are in; the flat counter
    # after floor_patience = 3 flat segments (judged one segment late).
    assert refreshes[0] - first == (5 if split == 0.9 else 4)


@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_joint_checkpoint_resumes_across_packages(deep_problem, monkeypatch,
                                                  tmp_path, writer, reader):
    """A joint run killed in the refinement after a probe refresh leaves a
    checkpoint with the refresh budget it has left (3); the other package
    resumes it and runs the remaining stages of the uninterrupted run."""
    _, _, s_ref = scripted_run("jax", ScriptedSolver(0.9), monkeypatch,
                               deep_problem)
    names = [n for n, _ in s_ref]
    first_chain_end = names.index("split:xla")
    refresh_end = names.index("split:xla", names.index(
        "xla:joint", first_chain_end))
    crash = refresh_end + 2  # the second segment after the refresh
    path = str(tmp_path / "joint.ckpt.npz")
    solver = ScriptedSolver(0.9)
    solver.crash_at = crash + 1
    with pytest.raises(RuntimeError, match="simulated"):
        scripted_run(writer, solver, monkeypatch, deep_problem,
                     checkpoint_path=path, checkpoint_every=1)
    assert int(tck.load(path)["ctl"]["refreshes"]) == 3
    resumed = ScriptedSolver(0.9)
    resumed.state = dict(solver.state)
    _, _, s_res = scripted_run(reader, resumed, monkeypatch, deep_problem,
                               checkpoint_path=path, checkpoint_every=1)
    assert_same_stages(s_ref[crash:], s_res, tol=0)
    assert not os.path.exists(path)


# -- more than one angle and more than one mode -----------------------------

GEOM2 = tikejax.Geometry(nz=48, n=48, nscan=16, ndet=32, nprb=16, ntheta=2,
                         nmodes=2)
DEEP2 = tikejax.Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=16, ntheta=2,
                         nmodes=2)


@pytest.fixture(scope="module")
def problem2():
    return perturbed_problem(GEOM2, 1, 11)


@pytest.mark.parametrize("jax_kw, port_kw", [
    (dict(), None),
    (dict(model="poisson"), None),
    (dict(linesearch="backtracking"), dict(kernel="fused_mx")),
], ids=["gaussian", "poisson", "fused_mx"])
def test_two_angles_two_modes_joint_run_matches_jax(problem2, jax_kw,
                                                    port_kw):
    """ntheta = 2, nmodes = 2: the joint oracle body and the fused tiers'
    joint body (plain versions) against the JAX package's oracle body, 12
    iterations in float64 to 1e-8."""
    jax_kw = dict(piter=12, kernel="xla", recover_prb=True, **jax_kw)
    port_kw = jax_kw if port_kw is None else dict(
        piter=12, recover_prb=True, **port_kw)
    data, p0, scan, prb0, _ = problem2
    pj, prj, mj = jcg.run(*map(jnp.asarray, (data, p0, scan, prb0)), GEOM2,
                          **jax_kw)
    pt, prt, mt = tcg.run(*map(cpu, (data, p0, scan, prb0)),
                          geometry_from(GEOM2), **port_kw)
    assert prt.shape == GEOM2.prb_shape
    assert_same_joint_trajectory(
        (np.asarray(pj), np.asarray(prj),
         {k: np.asarray(v) for k, v in mj.items()}),
        (to_numpy(pt), to_numpy(prt),
         {k: (to_numpy(v) if torch.is_tensor(v) else v)
          for k, v in mt.items()}), tol=1e-8)
    assert np.count_nonzero(to_numpy(mt["gamma_prb"])) > 6  # the probe moved


def test_two_angles_two_modes_joint_reconstruct_matches_jax():
    """reconstruct(recover_prb=True) at ntheta = 2, nmodes = 2: the joint
    stage 1, the escalation chain and the refinement with the probe
    frozen, stage for stage."""
    problem = perturbed_problem(DEEP2, 4, 13)
    # A shallow target keeps the joint stages short (32 iterations in all):
    # joint trajectories are chaotic past ~50.
    kw = dict(DEEP_KW, target_residual=1.5e-2, segment=8, max_segments=6,
              tiers=(("xla", 4e-2, 24),))
    pj, prj, sj = jreconstruct(*map(jnp.asarray, problem[:4]), DEEP2,
                               recover_prb=True, **kw)
    pt, prt, st = reconstruct(*map(cpu, problem[:4]), geometry_from(DEEP2),
                              recover_prb=True, **kw)
    assert_same_stages(sj, st)
    names = [n for n, _ in st]
    assert names[:5] == ["xla:joint"] * 5 and names[5:] == (
        ["split:xla"] * (len(names) - 5)) and len(names) > 5
    np.testing.assert_allclose(to_numpy(prt), np.asarray(prj), rtol=0,
                               atol=1e-8 * np.abs(prj).max())
