"""The L-BFGS direction in its compact form (``solvers.cg._Engine.
lbfgs_direction``: one ``lbfgs_gram`` pass, the two-loop recursion on
scalars in float64, one ``lbfgs_combine`` pass) against a transcription of
the two-loop recursion on arrays (the JAX package's, one inner product and
one axpy a pair and loop), in complex128 to 1e-12 relative; the ring it keeps
in place against the concatenated ring of the transcription; and the
kernels ``lbfgs_gram`` and ``lbfgs_combine`` against their plain versions on
the card (marked ``cuda``: without a CUDA device those tests skip). On a
machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_lbfgs.py
"""

import math

import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from tikejax_torch import Geometry  # noqa: E402
from tikejax_torch.models import make_problem  # noqa: E402
from tikejax_torch.ops import lbfgs  # noqa: E402
from tikejax_torch.solvers import cg as tcg  # noqa: E402

GEOM = Geometry(nz=12, n=10, nscan=4, ndet=8, nprb=4, ntheta=2)
C128 = torch.complex128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TwoLoop:
    """The two-loop recursion on arrays, with a ring concatenated on every
    push (oldest first), as the JAX package computes it; inner products
    over the first ``rows`` rows of each plane."""

    def __init__(self, m, like, rows):
        self.m, self.rows, self.count = m, rows, 0
        self.S = [torch.zeros_like(like) for _ in range(m)]
        self.Y = [torch.zeros_like(like) for _ in range(m)]
        self.sy = [0.0] * m

    def dot(self, a, b):
        r = self.rows
        return float(torch.vdot(a[..., :r, :].reshape(-1),
                                b[..., :r, :].reshape(-1)).real)

    def push(self, s, y, accepted):
        if not accepted:
            return
        sy, ss, yy = self.dot(s, y), self.dot(s, s), self.dot(y, y)
        if not sy > 1e-12 * math.sqrt(ss * yy):
            return
        self.S, self.Y = self.S[1:] + [s], self.Y[1:] + [y]
        self.sy = self.sy[1:] + [sy]
        self.count = min(self.count + 1, self.m)

    def direction(self, g):
        m = self.m
        rho = [1.0 / max(v, 1e-300) if v > 0 else 0.0 for v in self.sy]
        valid = [i >= m - self.count for i in range(m)]
        q, al = g, [0.0] * m
        for i in reversed(range(m)):
            if valid[i]:
                al[i] = rho[i] * self.dot(self.S[i], q)
                q = q - al[i] * self.Y[i]
        if self.count > 0:
            yy = self.dot(self.Y[m - 1], self.Y[m - 1])
            q = q * (self.sy[m - 1] / max(yy, 1e-300) if yy > 0 else 1.0)
        for i in range(m):
            if valid[i]:
                b = rho[i] * self.dot(self.Y[i], q)
                q = q + (al[i] - b) * self.S[i]
        return -q


def engine(m, halo=0):
    eng = tcg._Engine(GEOM, tcg.CGOptions(direction=f"lbfgs:{m}"), "cpu")
    eng.comm.halo = halo  # the owned rows of an object slab
    return eng


def scenario_steps(m, scenario):
    """(gamma_prev, kind) of each step after the first: kind 'good' makes a
    pair of positive curvature, 'bad' one that the guard rejects, 'fail' a
    failed line search (count reset, the next step not accepted)."""
    if scenario.startswith("count"):
        return [(0.75, "good")] * int(scenario[5:])
    good = [(0.5 + 0.25 * (k % 3), "good") for k in range(m + 1)]
    if scenario == "wrapped":
        return good + good
    if scenario == "guard":
        return good[:2] + [(1.0, "bad")] + good
    if scenario == "reset":
        return good[:m] + [(0.0, "fail")] + good
    return good + good[:3]  # carried, halo


SCENARIOS = [(m, f"count{c}") for m in (1, 4, 8) for c in range(m + 1)] + [
    (m, s) for m in (1, 4, 8) for s in ("wrapped", "guard", "reset",
                                        "carried", "halo")]


@pytest.mark.parametrize("m, scenario", SCENARIOS,
                         ids=[f"m{m}-{s}" for m, s in SCENARIOS])
def test_compact_direction_matches_the_two_loop(m, scenario):
    gen = torch.Generator().manual_seed(1000 * m + len(scenario))

    def rand():
        return torch.randn(GEOM.psi_shape, generator=gen, dtype=C128)

    halo = 3 if scenario == "halo" else 0
    rows = GEOM.nz - halo
    eng = engine(m, halo)
    lb = eng.lbfgs_init(rand())
    ref = TwoLoop(m, lb.S[0], rows)
    weight = 0.5 + 1.5 * torch.rand(GEOM.psi_shape, generator=gen,
                                    dtype=torch.float64)
    g_prev, d, gamma = rand(), torch.zeros(GEOM.psi_shape, dtype=C128), 0.0
    g = rand()
    steps = scenario_steps(m, scenario)
    for t in range(len(steps) + 1):
        if scenario == "carried" and t == len(steps) - 2:
            # A new run from the exported ring: the Gram rebuilt in one
            # product on the device and one host read.
            state = lb.export(torch.float64)
            age = [lb.slot(i) for i in range(m)]
            age += [m + k for k in age]
            kept = torch.tensor(lb.gram, dtype=torch.float64)[age][:, age]
            eng = engine(m)
            lb = eng.lbfgs_init(g, state)
            assert eng.syncs == 1 and lb.count == ref.count
            torch.testing.assert_close(
                torch.tensor(lb.gram, dtype=kept.dtype), kept, rtol=1e-12,
                atol=0)
        syncs = eng.syncs
        s = gamma * d
        ref.push(s, g - g_prev, gamma > 0)
        d_ref = ref.direction(g)
        d_new = eng.lbfgs_direction(lb, g, g_prev, d, gamma)
        assert lb.count == ref.count
        assert eng.syncs - syncs == int(gamma > 0 or lb.count > 0)
        err = torch.linalg.norm(d_new - d_ref) / torch.linalg.norm(d_ref)
        assert err <= 1e-12, (t, float(err))
        S, Y, sy, count = lb.export(torch.float64)
        assert torch.equal(S, torch.stack(ref.S))
        assert torch.equal(Y, torch.stack(ref.Y))
        torch.testing.assert_close(sy, torch.tensor(ref.sy, dtype=sy.dtype),
                                   rtol=1e-12, atol=0)
        assert int(count) == ref.count
        if t == len(steps):
            break
        gamma, kind = steps[t]
        d = d_ref
        if kind == "fail":
            lb.count = ref.count = 0  # what the loop's record() does
            continue
        sign = -1.0 if kind == "bad" else 1.0
        g_prev, g = g, g + sign * weight * (gamma * d) + 1e-3 * rand()


@pytest.mark.parametrize("direction, kw", [
    ("lbfgs", dict(kernel="fused_mx", linesearch="backtracking")),
    ("lbfgs:3", dict(kernel="xla", linesearch="backtracking")),
], ids=["merged", "classic"])
def test_one_gram_one_combine_and_one_read_an_iteration(direction, kw):
    """A run from a fresh start: one combination an iteration, one Gram
    pass and one host read an iteration after an accepted step, and no
    other read than the line search's and the two at the start."""
    gen = torch.Generator().manual_seed(3)
    _, scan, prb, data = make_problem(gen, GEOM, dtype=C128, device="cpu")
    psi0 = torch.ones(GEOM.psi_shape, dtype=C128)
    gram0 = lbfgs.lbfgs_gram_reference.launches
    comb0 = lbfgs.lbfgs_combine_reference.launches
    _, _, mt = tcg.run(data, psi0, scan, prb, GEOM, piter=12,
                       direction=direction, **kw)
    n = int(mt["iters_run"])
    gamma = mt["gamma"][:n].tolist()
    grams = lbfgs.lbfgs_gram_reference.launches - gram0
    assert n == 12 and all(v > 0 for v in gamma)
    assert lbfgs.lbfgs_combine_reference.launches - comb0 == n
    assert grams == sum(v > 0 for v in gamma[:-1])
    # Setup: sum(data) and, merged, the first objective; then one read a
    # line-search candidate (the classic body's gradient pass reads its
    # objective too) and one a direction with a Gram pass.
    merged = kw["kernel"] == "fused_mx"
    candidates = mt["evaluations"] - (1 if merged else n)
    reads = 1 + (1 if merged else n) + candidates + grams
    assert mt["host_syncs"] == reads


# -- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def same_bits(a, b):
    """Equal bit for bit, NaNs included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    ra, rb = torch.view_as_real(a), torch.view_as_real(b)
    return torch.equal(ra.view(ints[ra.dtype]), rb.view(ints[rb.dtype]))


def ring_inputs(dev, shape, m, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*lead):
        return torch.randn(lead + shape, generator=gen, device=dev,
                           dtype=dtype)

    return rand(m), rand(m), rand(), rand(), rand()


@pytest.mark.cuda
@pytest.mark.parametrize("shape, rows, dtype", [
    ((1, 512, 512), None, torch.complex64),
    ((1, 512, 512), 500, torch.complex64),
    ((2, 40, 36), 33, torch.complex128),
], ids=["512-c64", "512-owned-rows", "small-c128"])
def test_kernels_match_plain_on_the_card(dev, shape, rows, dtype):
    """Both kernels against their plain versions (on CPU copies) at 512^2,
    complex64, m = 8; two calls give the same bits."""
    m, gamma = 8, 0.625
    S, Y, g, gp, dp = ring_inputs(dev, shape, m, dtype)
    cpu = [x.cpu() for x in (S, Y, g, gp, dp)]
    before = lbfgs.lbfgs_gram.launches
    prods = lbfgs.lbfgs_gram(S, Y, g, gp, dp, gamma, rows)
    assert lbfgs.lbfgs_gram.launches == before + 1
    assert torch.equal(prods, lbfgs.lbfgs_gram(S, Y, g, gp, dp, gamma, rows))
    plain = lbfgs.lbfgs_gram_reference(*cpu, gamma, rows)
    assert prods.shape == (3, 2 * m + 3) and prods.dtype == torch.float64
    torch.testing.assert_close(prods.cpu(), plain, rtol=1e-10, atol=1e-8)

    a = [0.5 - 0.1 * k for k in range(m)]
    b = [0.0 if k == 2 else 0.2 * k - 0.7 for k in range(m)]
    a[5] = b[5] = 0.0  # a slot that is not read
    S[5] = float("nan")
    cpu[0][5] = float("nan")
    slot = 3
    S2, Y2 = S.clone(), Y.clone()
    d = lbfgs.lbfgs_combine(S, Y, g, gp, dp, gamma, slot, 0.875, a, b)
    d2 = lbfgs.lbfgs_combine(S2, Y2, g, gp, dp, gamma, slot, 0.875, a, b)
    assert same_bits(d, d2) and same_bits(S, S2) and same_bits(Y, Y2)
    d_plain = lbfgs.lbfgs_combine_reference(*cpu, gamma, slot, 0.875, a, b)
    assert torch.equal(S[slot].cpu(), cpu[0][slot])
    assert torch.equal(Y[slot].cpu(), cpu[1][slot])
    assert torch.isfinite(d).all()
    # The same sums in double, but for contracted multiply-adds: at most an
    # ulp apart after the one rounding in complex64.
    eps = torch.finfo(torch.empty(0, dtype=dtype).real.dtype).eps
    size = 0.875 + sum(map(abs, a)) + sum(map(abs, b))
    bound = 4 * eps * size * max(float(x.abs().nan_to_num().max())
                                 for x in cpu)
    assert float((d.cpu() - d_plain).abs().max()) <= bound


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take(dev):
    S, Y, g, gp, dp = ring_inputs(dev, (1, 16, 16), 2, torch.complex64)
    with pytest.raises(TypeError, match="complex64 or complex128"):
        lbfgs.lbfgs_gram(*(x.real.contiguous() for x in (S, Y, g, gp, dp)),
                         1.0)
    with pytest.raises(TypeError, match="takes g as"):
        lbfgs.lbfgs_gram(S, Y, g.to(torch.complex128), gp, dp, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        lbfgs.lbfgs_combine(S, Y, g.mT, gp, dp, 1.0, 0, 1.0, [0.0] * 2,
                            [0.0] * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("direction, kw", [
    ("lbfgs", dict(kernel="fused_mx", linesearch="backtracking")),
], ids=["merged"])
def test_one_gram_one_combine_an_iteration_on_the_card(dev, direction, kw):
    """A small ``run(direction='lbfgs')`` on the card: the wrappers'
    ``launches`` count one combination an iteration and one Gram pass an
    iteration after an accepted step, and ``metrics['host_syncs']`` holds
    one read a Gram pass and none besides the line search's."""
    g = Geometry(nz=64, n=64, nscan=16, ndet=32, nprb=24)
    gen = torch.Generator(device=dev).manual_seed(5)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64, device=dev)
    gram0, comb0 = lbfgs.lbfgs_gram.launches, lbfgs.lbfgs_combine.launches
    _, _, mt = tcg.run(data, psi0, scan, prb, g, piter=16,
                       direction=direction, **kw)
    n = int(mt["iters_run"])
    gamma = mt["gamma"][:n].tolist()
    grams = lbfgs.lbfgs_gram.launches - gram0
    assert n == 16
    assert lbfgs.lbfgs_combine.launches - comb0 == n
    assert grams == sum(v > 0 for v in gamma[:-1]) > 0
    assert mt["host_syncs"] == 2 + (mt["evaluations"] - 1) + grams
