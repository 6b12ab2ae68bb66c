#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tikejax_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and nothing else of the network or the host, and has no
CPU path: without a card, or without the repository beside it, it fails.

Phases, one line each (any failure exits non-zero; no phase's error is
caught):
  1. device   -- the card (nvidia-smi name and power limit), torch, CUDA;
  2. build    -- nvcc builds the grad_fused kernel from tikejax_torch/csrc;
  3. kernel   -- grad_fused (the CUDA kernel) against grad_fused_reference
                 (its plain PyTorch version) on a small awkward case and at
                 the headline frame size, with both times;
  4. solver   -- a small problem against the CPU complex128 oracle solver;
  5. main     -- the headline problem (512^2 object, 16384 positions, 128^2
                 probe and detector, Gaussian, solver defaults) through
                 solvers.run, checking that every evaluation launched the
                 kernel, that the residual fell tenfold and that nothing
                 farplane-sized was allocated.
The line before the last is the card's nvidia-smi line; before it, one JSON
line describing each kernel; the last line is the JSON result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GRAD_TOL = 1e-4   # max|g - g_ref| / max|g_ref| (the JAX fused parity bound)
MINF_TOL = 1e-5   # |f - f_ref| / |f_ref|
# Small solve, complex64 kernel vs the complex128 oracle solver: float32
# rounding alone (1.6e-6 on the CPU plain path at these shapes).
SOLVE_TOL = 1e-4
SEED = 0
HEADLINE = dict(nz=512, n=512, nscan=16384, ndet=128, nprb=128)
MAIN_ITERS = 100


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (asserts vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def median_ms(torch, fn, reps: int) -> float:
    """Median of ``reps`` synchronised calls, timed with CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, fused, args, ndet, model):
    """Kernel vs plain version on the same inputs: (grad err, minf err,
    max abs err)."""
    g_k, f_k = fused.grad_fused(*args, ndet, model)
    g_r, f_r = fused.grad_fused_reference(*args, ndet, model)
    torch.cuda.synchronize()
    abs_err = float((g_k - g_r).abs().max())
    g_err = abs_err / float(g_r.abs().max())
    f_err = abs(float(f_k) - float(f_r)) / abs(float(f_r))
    check(bool(torch.isfinite(g_k).all()) and g_err <= GRAD_TOL
          and f_err <= MINF_TOL, (model, g_err, f_err))
    return g_err, f_err, abs_err


def main() -> None:
    if not (ROOT / "tikejax_torch" / "csrc" / "grad_fused.cu").is_file():
        raise SystemExit("chip_smoke.py: tikejax_torch/ is not beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    from tikejax_torch import Geometry
    from tikejax_torch.models import make_problem
    from tikejax_torch.ops import fused
    from tikejax_torch.ops.patches import scan_to_int
    from tikejax_torch.solvers import run
    from tikejax_torch.utils import cuda_build

    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    # Plain fp32 everywhere: the reference must not run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    dev = torch.device("cuda", 0)

    # -- 2. build --------------------------------------------------------
    path, seconds, report = cuda_build.build("grad_fused")
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", f"{path.relative_to(ROOT)} in {seconds:.1f} s; "
        + " | ".join(ptxas))

    # -- 3. kernel vs plain version ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def crandn(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))

    small = Geometry(nz=97, n=101, nscan=37, ndet=72, nprb=56, ntheta=2,
                     nmodes=2)
    _, scan_s, prb_s, data_s = make_problem(gen, small, device=dev)
    scan_si = scan_to_int(scan_s)
    scan_si[1, 5, 0] = -1  # one masked dummy position
    psi_s = crandn(*small.psi_shape)
    for model in ("gaussian", "poisson"):
        g_err, f_err, _ = compare(torch, fused,
                                  (psi_s, data_s, scan_si, prb_s),
                                  small.ndet, model)
        log("kernel", f"small {small} {model}: grad err {g_err:.2e}, "
            f"minf err {f_err:.2e}")

    g = Geometry(**HEADLINE)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64, device=dev)
    args = (psi0, data, scan_to_int(scan), prb)
    g_err, f_err, abs_err = compare(torch, fused, args, g.ndet, "gaussian")
    ms = median_ms(torch, lambda: fused.grad_fused(*args, g.ndet,
                                                   "gaussian"), 10)
    plain_ms = median_ms(torch, lambda: fused.grad_fused_reference(
        *args, g.ndet, "gaussian"), 10)
    flops = 2 * 8 * g.ndet * g.nprb * (g.nprb + g.ndet) * g.nscan
    log("kernel", f"headline {g}: grad err {g_err:.2e}, minf err "
        f"{f_err:.2e}; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s fp32), plain {plain_ms:.3f} ms, median of 10 on {card}")

    # -- 4. small solve against the CPU oracle ----------------------------
    sg = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)
    _, s_scan, s_prb, s_data = make_problem(gen, sg, device=dev)
    s_psi0 = torch.ones(sg.psi_shape, dtype=torch.complex64, device=dev)
    fused.grad_fused.launches = 0
    _, _, mk = run(s_data, s_psi0, s_scan, s_prb, sg, piter=20)
    check(fused.grad_fused.launches == mk["evaluations"] > 0,
          (fused.grad_fused.launches, mk["evaluations"]))
    _, _, mo = run(s_data.double().cpu(), s_psi0.to(torch.complex128).cpu(),
                   s_scan.cpu(), s_prb.to(torch.complex128).cpu(), sg,
                   piter=20, kernel="xla", linesearch="backtracking")
    fk, fo = mk["minf"].cpu().double(), mo["minf"]
    rel = float(((fk - fo).abs() / fo.abs()).max())
    check(int(mk["iters_run"]) == int(mo["iters_run"]) == 20
          and rel < SOLVE_TOL, (rel, mk["minf"], mo["minf"]))
    log("solver", f"small {sg} 20 iters: per-iteration minf within "
        f"{rel:.2e} of the CPU complex128 oracle solver")

    # -- 5. the main path -------------------------------------------------
    run(data, psi0, scan, prb, g, piter=3)  # warm-up
    fused.grad_fused.launches = 0
    fused.grad_fused_reference.launches = 0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    psi, _, m = run(data, psi0, scan, prb, g, piter=MAIN_ITERS,
                    model="gaussian")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    launches = fused.grad_fused.launches
    check(fused.grad_fused_reference.launches == 0, "plain version ran")
    check(launches == m["evaluations"] > 0, (launches, m["evaluations"]))
    iters = int(m["iters_run"])
    minf = m["minf"][:iters].cpu()
    res = m["residual"][:iters].cpu()
    check(psi.shape == g.psi_shape and bool(torch.isfinite(psi).all()),
          "psi shape or finiteness")
    check(float(minf[-1]) < float(minf[0]), minf)
    check(float(res[-1]) <= 0.1 * float(res[0]), res)
    check(peak < 1024**3, f"peak extra memory {peak} bytes")
    log("main", f"{g} gaussian, solver defaults, {iters} iters in "
        f"{seconds:.3f} s: {iters / seconds:.2f} iters/s, "
        f"{1e3 * seconds / iters:.2f} ms/iter, "
        f"{m['evaluations'] / iters:.2f} evals/iter, "
        f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
        f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, peak extra memory "
        f"{peak / 2**20:.1f} MiB, on {card}")

    print(json.dumps({"kernels": [{
        "name": "grad_fused", "route": "cuda",
        "source": "tikejax_torch/csrc/grad_fused.cu",
        "replaces": "tikejax/ops/pallas_fused.py:1283",
        "launches": launches, "max_abs_err": abs_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
