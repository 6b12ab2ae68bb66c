"""The card's published peaks and a kernel's least time.

The work of an operator comes from its shapes, whatever kernels implement
it: the real FLOPs of its 2-D FFTs (5 N log2 N per frame of N pixels, each
valid frame and mode) at the float32 SIMT peak, and each input read once
and each output written once at the memory peak. The least time is the
larger of the two; a kernel's roofline share is that time over its own.
Peaks: NVIDIA's data sheet for the H100 SXM part at its 700 W limit
(float32 outside the tensor cores, HBM3); a card set below 700 W runs
slower under load, so every run prints the card's power limit beside them.
"""

from __future__ import annotations

import math
import subprocess

PEAK_FLOPS = 67e12  # float32, SIMT
PEAK_BYTES = 3.35e12  # HBM3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fft_flops(frames: int, nmodes: int, ndet: int, dfts: int) -> float:
    """Real FLOPs of ``dfts`` 2-D FFTs of ``frames`` frames of ``nmodes``
    modes on an ``ndet`` x ``ndet`` detector."""
    n = ndet * ndet
    return dfts * frames * nmodes * 5 * n * math.log2(n)


def bound(flops: float, moved: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time for ``flops`` float32
    operations and ``moved`` bytes."""
    flops_ms = 1e3 * flops / PEAK_FLOPS
    bytes_ms = 1e3 * moved / PEAK_BYTES
    return ((flops_ms, "operations") if flops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return "; ".join(line.strip() for line in out.stdout.splitlines())


def gradient_share(run, op: str, writes: str) -> float | None:
    """The share of its least time that the gradient operator
    ``tikejax_torch.ops.fused.<op>`` reaches on the cell's own inputs, in %;
    None off the card, outside a cell of jobs, or for a probe gradient
    where the probe is not recovered.

    After the window the operator runs on the object and probe of the last
    job on the pool's first problem, that problem's data and its scan's
    corners, timed with CUDA events: a warm-up, then the median of 10. Its
    least time is its work from its shapes, whatever kernels implement it:
    two 2-D FFTs of every frame; the object, probe, data and corners read
    once, and the gradient (of the object or the probe, as ``writes``
    says) and the objective written once."""
    if not run.jobs or not run.on_card:
        return None
    import torch

    k = min(run.last)
    psi, prb, _ = run.last[k]
    p = run.problems[k]
    if writes == "prb" and not p.recover_prb:
        return None
    corners = torch.floor(p.scan).to(torch.int32)
    g = p.geometry
    ms = run.time_ms(lambda: getattr(run.program.fused, op)(
        psi, p.data, corners, prb, g["ndet"], p.model))
    least, by = bound(
        fft_flops(g["ntheta"] * g["nscan"], g["nmodes"], g["ndet"], 2),
        nbytes(psi, prb, p.data, corners, {"psi": psi, "prb": prb}[writes])
        + 4)
    run.note(f"{op} {ms!r} ms, least {least!r} ms (by {by})")
    return 100.0 * least / ms
