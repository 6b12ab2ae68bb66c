#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tikejax_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and nothing else of the network or the host, and has no
CPU path: without a card, or without the repository beside it, it fails.

Phases, one line each or more (any failure exits non-zero; no phase's error
is caught):
  1. device    -- the card (nvidia-smi name and power limit), torch, CUDA;
  2. build     -- nvcc builds the twelve kernels (grad_fused, fwd,
                  minf_fused, grad_prb_fused, adj, adj_probe, adj_residual,
                  fwd_quad_stats, ls_objectives, gather_probe_mul,
                  scatter_conj_probe, adj_probe_reduce) and the L-BFGS
                  direction's two (lbfgs_gram, lbfgs_combine) from
                  tikejax_torch/csrc, one process per source, in parallel,
                  into the build directory it prints;
  3. kernel    -- each kernel against its plain PyTorch version on a small
                  awkward case (2 angles, 2 modes, odd sizes, a masked
                  position, both models) and at the headline frame size:
                  grad_fused with and without a base, fwd with and without
                  a base and as split views, minf_fused with and without a
                  base, grad_prb_fused, adj, adj_probe, adj_residual,
                  fwd_quad_stats for the object and the probe direction,
                  ls_objectives at 17 steps, and the hybrid tier's
                  gather_probe_mul, scatter_conj_probe and adj_probe_reduce
                  (the adjoints on the strided crop of 72^2 frames to
                  56^2); the probe reductions, fwd_quad_stats,
                  ls_objectives and the three hybrid kernels also
                  bitwise repeatable; gather_probe_mul's
                  persistent kernel with masked frames all zero, on the
                  headline (one position masked) and on awkward cases
                  (odd and even n, nprb 56, 48 and the odd 55);
                  scatter_conj_probe's tile kernel bitwise repeatable and
                  held to the plain version and to the forced atomic
                  kernel it replaced on the headline (one position masked)
                  and on awkward cases (n 101 and 102, nprb 56, 55 and 48,
                  2 angles x 2 modes, strided crops, windows on the last
                  row and column), the same bits with its chunk skip
                  forced off, every position masked giving exactly
                  zero; kernel and
                  plain times at the headline size beside each kernel's
                  bound; <fwd(x), y> = <x, adj(y)> to 1e-5 at the headline.
                  grad_fused, minf_fused, grad_prb_fused, fwd, adj,
                  adj_probe, adj_residual and fwd_quad_stats have two
                  kernels each (ops.fused
                  dft_variant): the small case above (72^2) runs 'gemm',
                  the headline 'fft'; both variants, forced, are also held
                  to the plain versions on a power-of-two awkward case (2
                  angles, 2 modes, 48^2 probe in a 64^2 detector, a masked
                  position, both models, with and without a base) and at
                  the headline: every objective, both probe sums, fwd's
                  farplane, fwd_quad_stats' planes and every object
                  gradient bitwise repeatable,
                  and on 'fft' the three objectives equal bit for bit (a
                  line search compares them), fwd's farplane, given to
                  minf_fused as a base of zeros, giving minf_fused's
                  objective bit for bit (also at 4 modes in phase 10), and
                  fwd_quad_stats of a direction on fwd's farplane of it
                  giving a == b == c bit for bit; then one line per
                  redesigned
                  kernel: FFT and forced 'gemm' times taken in turns in
                  this run, registers, spills, shared memory, resident
                  blocks and the share of the bound (adj also at the stream
                  path's 1024 frames); ls_objectives at 1 and 17 steps for
                  both models and gather_probe_mul at 16384 and 4096
                  frames beside their bounds; scatter_conj_probe's tile
                  kernel against the forced atomic kernel, in turns, at
                  both frame counts (the new one must be faster at both);
                  adj (its frames summed by the
                  tile kernel in scan order, chunk after chunk) bitwise
                  repeatable on both variants at 16384 and 1024 frames and
                  timed in turns against the forced one-pass atomic kernel
                  it replaced at both; grad_fused and adj_residual in scan
                  order likewise (their frames of a chunk, then the tile
                  scatter): bitwise repeatable on both variants, the same
                  bits whatever the chunk, within 1e-5 of scale of the
                  forced atomic kernels with their objectives bit for bit,
                  grad_fused(psi)'s gradient adj_residual(fwd(psi))'s bit
                  for bit, timed in turns against the atomic kernels with
                  512, 128 and 32 MiB of frame scratch; grad_fused's
                  two FFT bodies at the headline (the fused one the shapes
                  pick, the shared-memory one forced with
                  variant='fft_smem'): the same bits for both models,
                  without and with a base, at 512 and 32 MiB of frame
                  scratch, masked and out-of-bounds positions in the scan,
                  the objective minf_fused's, then timed in turns (the
                  whole call and the frame kernels alone) beside the
                  bound; minf_fused's two FFT bodies likewise: the same
                  objective, and grad_fused's, for both models, without
                  and with a base, with and without the data prefetch,
                  then in turns at 16384 and at 4096 positions (the joint
                  cell's launch) beside the bound, and each kernel alone;
                  the 'fft' fwd
                  farplane, adj, adj_probe, adj_residual and grad_fused at
                  64^2 and 128^2, 1 and 4 modes, against a complex128
                  oracle on the card: the fused_hp bound (~4e-7) held;
                  lbfgs_gram and lbfgs_combine at the headline object
                  (512^2, complex64) and m = 8 against their plain
                  versions, bitwise repeatable, the pair stored in its
                  slot, timed beside their bounds, their plain versions
                  and the compact plain form (one matrix product for the
                  Gram, one matrix-vector product for the combination, in
                  float32 and float64);
  4. solver    -- a small problem against the CPU complex128 oracle solver;
  5. main      -- the headline problem (512^2 object, 16384 positions, 128^2
                  probe and detector, Gaussian, solver defaults) through
                  solvers.run, checking that every evaluation launched the
                  kernel (its 'fft' variant's fused body, one frame-kernel
                  launch a chunk of frames: grad_fused.body_launches; so
                  in phase deep), that the residual fell tenfold and that
                  peak extra memory stayed below 83.4 MiB (what the 'gemm'
                  variant's scratch made it) and the 512 MiB frame scratch;
  6. deep      -- the headline through solvers.reconstruct with its defaults
                  to a 1e-6 relative residual from psi0 = ones, timed
                  between two torch.cuda.synchronize(): the target must be
                  reached, fwd ('fft') must freeze every base and make
                  every Anderson candidate, grad_fused ('fft') must run
                  every evaluation, lbfgs_combine must run once a
                  refinement (L-BFGS) iteration and lbfgs_gram once an
                  accepted step there (and at most once more a segment),
                  and no plain version may run;
  7. materialized -- the headline through solvers.run(memory=
                  'materialized'), 100 iterations: fwd, adj_residual and
                  fwd_quad_stats (all 'fft') once an iteration, no grad_fused or
                  minf_fused, the residual fallen tenfold, peak extra
                  memory below G psi, the three statistics planes and
                  0.5 GiB; then 8 iterations under torch.profiler: the
                  share of the time the card is busy and the kernels that
                  take the most of it (also in phases 8 and 13);
  8. fused-ls  -- the same with fused_linesearch=True: two fwd, one
                  adj_residual and one ls_objectives (frame-major) an
                  iteration, no
                  fwd_quad_stats, the residual fallen tenfold, peak extra
                  memory below two farplanes and 0.5 GiB;
  9. hybrid    -- the headline through solvers.run(kernel='pallas'), 100
                  iterations: cuFFT between gather_probe_mul (at least
                  twice an iteration) and scatter_conj_probe (once), no
                  fused kernel and no plain version, the residual fallen
                  tenfold, peak extra memory below G psi, the direction's
                  farplane, the three statistics planes, one cuFFT
                  workspace and 0.5 GiB;
 10. frameless -- 4 modes x 16384 positions x 128^2 (an 8.6 GB farplane,
                  past the 3 GiB threshold): first grad_fused, minf_fused
                  and fwd(split_out=True), each with and without a base
                  given as split views, adj and adj_probe on the 8 GiB
                  farplane (grad_fused, minf_fused, adj and adj_probe on
                  'fft'),
                  and the three hybrid kernels,
                  against their plain versions at
                  this full size (float offsets past 2^31), grad_fused and
                  adj_residual in scan order as in phase 3; then
                  reconstruct at a cut depth: the frameless Anderson
                  safeguard must launch
                  minf_fused twice per step (on its shared-memory body,
                  which 4 modes pick), the residual must fall, and
                  peak extra memory must stay below one base farplane plus
                  1.5 GiB;
 11. joint     -- BASELINE config 3 (512^2 object, 4096 positions, 128^2
                  probe and detector, Poisson) through solvers.run(
                  recover_prb=True) for 128 iterations from psi0 = ones and
                  a probe perturbed by complex Gaussian noise at 3% of its
                  maximum: objective, residual and probe error (up to the
                  complex scale that the joint objective cannot fix) must
                  fall,
                  grad_fused and grad_prb_fused must launch once an
                  iteration and minf_fused once a candidate (every launch
                  on its fused body; so in phase joint-deep), all three on
                  their 'fft' variant, and peak extra
                  memory must stay below 256 MiB (frameless); then two
                  runs of 8 iterations must give the same psi, prb and
                  objectives bit for bit;
 12. materialized -- the same problem and start through run(
                  recover_prb=True, memory='materialized') for 64
                  iterations: adj_residual and adj_probe once an iteration,
                  fwd and fwd_quad_stats twice (all four on 'fft'),
                  objective and probe error
                  fallen, peak extra memory below 2 GiB;
 13. stream    -- the JAX package's quick start on the port: the same
                  problem, Gaussian, recover_prb=True, nchunks=4, 128
                  iterations: fwd, adj_probe and adj (all 'fft') must launch
                  on every chunk pass, the objective must fall, and peak extra
                  memory must stay below the streamed statistics and two
                  chunk farplanes (1.25 GiB);
 14. joint-deep -- the same problem (Gaussian) through reconstruct(
                  recover_prb=True) with its defaults to a 1e-6 residual:
                  a fused:joint stage 1, the fused_hp:joint escalation
                  chain, grad_prb_fused once a joint iteration, the target
                  reached and the probe error fallen;
 15. facade    -- the same problem (Poisson) and start as phase 11, handed
                  over as NUMPY arrays to compat.CGPtychoSolver(...,
                  kernel='pallas').run(recover_prb=True, piter=64): numpy
                  comes back, objective and probe error fall, per iteration
                  four gather_probe_mul, one scatter_conj_probe and one
                  adj_probe_reduce launch; the facade's fwd/adj/adj_probe
                  adjoint identities to 1e-5 on the small awkward case;
 16. options   -- precondition='illum_lowk' and linesearch='parabolic', 32
                  iterations each on the hybrid tier at config 3's size
                  (Gaussian): the objective falls;
 17. sharded   -- two gloo ranks (tikejax_torch.parallel.RankPool, each a
                  process of its own, both on the one card) through
                  parallel.run_sharded: BASELINE config 5 (512^2 object,
                  65536 positions, 128^2 probe and detector, Gaussian,
                  solver defaults) on a ('scan',) mesh, 8 iterations, and
                  config 3's shape on two angles (recover_prb=True) on a
                  (2, 1) ('theta', 'scan') mesh, Gaussian for 8 iterations
                  and Poisson on the bitwise-repeatable hybrid tier for 2
                  (the Poisson joint search amplifies rounding tenfold an
                  iteration, and its fused-tier run does not repeat even on
                  one rank), each held to the one-rank run of the same
                  problem (every rank builds it from the seed; an
                  all-reduced checksum shows they did): iterations and
                  evaluations equal, objectives, psi and prb within 1e-4 of
                  scale, the ranks bitwise equal with equal collective
                  counts; then the headline through reconstruct(mesh=) to
                  1e-6, beside phase 6's one-rank figure. All-reduces and
                  their bytes per iteration and the card's busy ms per
                  iteration of each rank are printed; no multi-GPU rate is
                  measured;
 18. tiled     -- object tiling (parallel.run_tiled), the ranks sharing the
                  card over gloo: the headline on a 2-slab ('obj',) mesh
                  (two ranks), 8 iterations, and config 3's shape (joint,
                  Gaussian) on a (2, 2) ('obj', 'scan') mesh (four ranks),
                  8 iterations, each held to the one-rank run as in phase
                  17; halo broadcasts and bytes, all-reduces per iteration
                  and each rank's real and padded positions are printed;
 19. large     -- the JAX package's large-object configurations, which
                  its TPU runs through object row slabs, here whole: 1024^2
                  and 2048^2 objects with 16384 positions and 1024^2 with
                  65536 (128^2 probe and detector, Gaussian, defaults)
                  through solvers.run (100, 100 and 32 iterations after a
                  warm-up: the residual fallen tenfold, grad_fused and the
                  tile scatter once a chunk of frames an evaluation, peak
                  extra memory below the frame scratch and 24 objects),
                  reconstruct to 1e-5 on the first (the reference's deep
                  slab row); before the runs at the two larger, grad_fused
                  (in scan order), minf_fused, fwd, adj, adj_probe and the
                  tile scatter against their plain versions over chunks of
                  8192 positions, the tile scatter bitwise repeatable and
                  the same bits with and without its chunk skip, grad_fused
                  the same bits at 512 and 32 MiB of frame scratch, each
                  timed beside its bound, and the tile kernel's walk alone
                  (every position masked, every chunk walked); the tile
                  scatter with and without the skip in turns at the
                  headline and at 2048^2.
No phase may run a plain version on the main path.
The line before the last is the card's nvidia-smi line; before it, one JSON
line describing each kernel (its launches on each phase that ran it, with
the frames -- positions times modes -- of one launch there, so that times
taken at the headline frame size can be scaled to each path); the last line
is the JSON result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

from h100bench import trace
from h100bench.roofline import bound, nbytes
from h100bench.roofline import fft_flops as frame_flops

ROOT = Path(__file__).resolve().parent
GRAD_TOL = 1e-4   # max|g - g_ref| / max|g_ref| (the JAX fused parity bound)
FAR_TOL = 1e-4    # max|f - f_ref| / max|f_ref|, the same bound
MINF_TOL = 1e-5   # |f - f_ref| / |f_ref|
# Small solve, complex64 kernel vs the complex128 oracle solver: float32
# rounding alone (1.6e-6 on the CPU plain path at these shapes).
SOLVE_TOL = 1e-4
SEED = 0
HEADLINE = dict(nz=512, n=512, nscan=16384, ndet=128, nprb=128)
MAIN_ITERS = 100
# Phase main's peak extra memory with the 'gemm' grad_fused, whose per-block
# scratch was most of it; the 'fft' variant must stay below it beside the
# frame scratch of its object scatter in scan order, a constant
# (fused.FRAME_SCRATCH_BYTES, 512 MiB), whatever the number of positions.
MAIN_PEAK = 83.4 * 2**20
# The power-of-two awkward case of the FFT variants.
POW2_SMALL = dict(nz=97, n=101, nscan=37, ndet=64, nprb=48, ntheta=2,
                  nmodes=2)
# Part of the mangled name of the instantiation the headline runs (side 128,
# 1024 threads, no base) and of the 'gemm' kernel, for the compiler's report.
HEADLINE_ENTRIES = {
    # grad_fused's FFT variant at the headline: its fused body.
    "grad_fused": ("grad_fused_regs_kernelILb0ELb1E",
                   "grad_fused_kernelILb0"),
    # minf_fused's likewise: its fused body, with the data prefetch.
    "minf_fused": ("minf_fused_regs_kernelILb0ELb1E",
                   "minf_fused_kernelILb0"),
    "grad_prb_fused": ("grad_prb_fused_fft_kernelILi128ELi1024EE",
                       "grad_prb_fused_kernelE"),
    "fwd": ("fwd_fft_kernelILi128ELi1024ELb0", "fwd_kernelILb0"),
    "adj": ("adj_fft_kernelILi128ELi1024EE", "adj_kernelE"),
    "adj_probe": ("adj_probe_fft_kernelILi128ELi1024EE",
                  "adj_probe_kernelE"),
    "adj_residual": ("adj_residual_fft_kernelILi128ELi1024EE",
                     "adj_residual_kernelE"),
    "fwd_quad_stats": ("fwd_quad_stats_fft_kernelILi128ELi1024EE",
                       "fwd_quad_stats_kernelE"),
}
# ls_objectives' kernel at the solver's 17 steps.
LS_ENTRY = "ls_objectives_frame_kernelILi17EE"
# gather_probe_mul's persistent kernel on pixel pairs.
GATHER_ENTRY = "gather_probe_mul_persistent_kernelILi2EE"
# scatter_conj_probe's atomic kernel; the tile kernel's instantiation is
# named from ops.kernels' mode chunk (scatter_entry).
SCATTER_ATOMIC_ENTRY = "scatter_conj_probe_atomic_kernelE"
# The tile kernel against the forced atomic one, of scale: the same sums in
# another order.
SCATTER_ORDER_TOL = 1e-5
# The stream path's frames a launch (4096 positions in 4 chunks) and the
# facade's and options' (config 3).
STREAM_FRAMES = 1024
CONFIG3_FRAMES = 4096
# <fwd(x), y> against <x, adj(y)>, relative: both through the frame's FFT.
PAIR_TOL = 1e-5
DEEP_TARGET = 1e-6
# About 11 s a 256-iteration segment: a run that does not converge ends
# within ~3 minutes.
DEEP_MAX_SEGMENTS = 16
FRAMELESS = dict(HEADLINE, nmodes=4)
FRAMELESS_KW = dict(tiers=(("fused", 5e-3, 64),), segment=32,
                    max_segments=4)
SCALE_CHUNK = 2048  # positions per plain-version chunk at 4 modes: 1 GiB
CONFIG3 = dict(nz=512, n=512, nscan=4096, ndet=128, nprb=128)
JOINT_ITERS = 128
MATERIALIZED_JOINT_ITERS = 64
MATERIALIZED_JOINT_PEAK = 2 * 2**30
STREAM_CHUNKS = 4
# The streamed (a, b, c) statistics of all positions (3 x 4096 x 128^2 x
# 4 B = 0.75 GiB) plus two chunk farplanes (0.25 GiB) and some slack.
STREAM_PEAK = 1.25 * 2**30
# The joint path holds no farplane (0.5 GiB here) and no data-sized
# temporary: this beside the frame scratch of grad_fused's object scatter
# in scan order, a constant (fused.FRAME_SCRATCH_BYTES).
JOINT_PEAK = 256 * 2**20
# A joint-deep run that does not converge ends within about a minute: each
# probe refresh costs one segment of the budget and ~4 x 128 joint
# iterations. The joint trajectory is chaotic (its rounding differences grow
# ~1.3x an iteration, and the gradient's atomics change them from run to
# run): of eight runs on an H100 seven reached 1e-6 after one probe refresh
# (14-16 stages, 10-16 s) and one after two (23 stages, 21 s), which the 12
# segments allowed while a run took a minute would only just have covered.
JOINT_DEEP_MAX_SEGMENTS = 24
# Special-function results a clock on one SM (square roots, logarithms).
SFU_PER_SM_CLOCK = 16
KERNEL_SOURCES = {
    "grad_fused": ("tikejax_torch/csrc/grad_fused.cu",
                   "tikejax/ops/pallas_fused.py:1283"),
    "fwd": ("tikejax_torch/csrc/fwd.cu", "tikejax/ops/pallas_fused.py:651"),
    "minf_fused": ("tikejax_torch/csrc/minf_fused.cu",
                   "tikejax/ops/pallas_fused.py:1424"),
    "grad_prb_fused": ("tikejax_torch/csrc/grad_prb_fused.cu",
                       "tikejax/ops/pallas_fused.py:1563"),
    "adj": ("tikejax_torch/csrc/adj.cu", "tikejax/ops/pallas_fused.py:759"),
    "adj_probe": ("tikejax_torch/csrc/adj_probe.cu",
                  "tikejax/ops/pallas_fused.py:866"),
    "adj_residual": ("tikejax_torch/csrc/adj_residual.cu",
                     "tikejax/ops/pallas_fused.py:1011"),
    "fwd_quad_stats": ("tikejax_torch/csrc/fwd_quad_stats.cu",
                       "tikejax/ops/pallas_fused.py:1123"),
    "ls_objectives": ("tikejax_torch/csrc/ls_objectives.cu",
                      "tikejax/ops/pallas_linesearch.py:65"),
    "gather_probe_mul": ("tikejax_torch/csrc/gather_probe_mul.cu",
                         "tikejax/ops/pallas_kernels.py:261"),
    "scatter_conj_probe": ("tikejax_torch/csrc/scatter_conj_probe.cu",
                           "tikejax/ops/pallas_kernels.py:349"),
    "adj_probe_reduce": ("tikejax_torch/csrc/adj_probe_reduce.cu",
                         "tikejax/ops/pallas_kernels.py:436"),
    # The L-BFGS direction's Gram and combination passes: they replace no
    # TPU kernel (the JAX package's two-loop is jnp in a fori_loop).
    "lbfgs": ("tikejax_torch/csrc/lbfgs.cu", None),
}
# The wrappers of lbfgs.cu, one line each in the kernels line.
LBFGS_WRAPPERS = ("lbfgs_gram", "lbfgs_combine")
LBFGS_M = 8  # the solver's default ring
LBFGS_SHAPE = (1, 512, 512)  # the headline object
# The reference's operator accuracy of its most accurate tier, fused_hp
# (tikejax/ops/diffraction.py: ~4e-7; fused_mp / fused_mx ~8e-6), here as
# max|err| / max|ref| against a complex128 oracle on the card.
HP_BOUND = 4e-7
# grad_fused's and adj_residual's frame scratch, timed in turns against the
# forced atomic kernel, MiB (the default is fused.FRAME_SCRATCH_BYTES).
SCAN_ORDER_BUDGETS = (512, 128, 32)
# Two one-rank joint Poisson runs of config 3's shape, held bit for bit.
JOINT_REPEAT_ITERS = 8
HYBRID_ITERS = 100
FACADE_ITERS = 64
# Phase 17, sharded: BASELINE config 5 (its source: "Position-sharded CG
# ..., 512^2 object, 64k positions"), 128^2 probe and detector, Gaussian,
# object-only, solver defaults, on two ranks of a ('scan',) mesh sharing the
# card; config 3's shape on two angles on a (2, 1) ('theta', 'scan') mesh;
# and the headline through reconstruct(mesh=) to 1e-6.
CONFIG5 = dict(nz=512, n=512, nscan=65536, ndet=128, nprb=128)
CONFIG3_THETA = dict(CONFIG3, ntheta=2)
SHARDED_ITERS = 8
THETA_ITERS = 8
# The Poisson joint search amplifies any difference of rounding from
# iteration to iteration, even where every kernel repeats bit for bit (the
# sums over angles then run in another order): its theta-mesh run is held
# after 2 iterations.
THETA_POISSON_ITERS = 2
# Sharded against one rank, of scale: the same kernels, the sums over the
# positions in another order.
SHARDED_TOL = 1e-4
# Phase 18, tiled: the headline on a 2-slab ('obj',) mesh and config 3's
# shape (joint, Gaussian) on a (2, 2) ('obj', 'scan') mesh, each held to
# one rank like phase 17's runs.
TILED_ITERS = 8
OPTION_ITERS = 32
LS_STEPS = [0.5 ** k for k in range(17)]  # the solver's default K
# Iterations of the profiled windows of phases 7, 8 and 13.
PROFILE_ITERS = 8
# Phase 19, large: the JAX package's large-object capability
# configurations (BASELINE.md rows "Slab campaign measured", "Large-object
# capability rows", "Deep time-to-target at slab scale"), which its TPU runs
# through row slabs of the object; here whole, on one card. Gaussian, solver
# defaults, one angle, one mode, 128^2 probe and detector.
LARGE = {"1024": dict(nz=1024, n=1024, nscan=16384, ndet=128, nprb=128),
         "2048": dict(nz=2048, n=2048, nscan=16384, ndet=128, nprb=128),
         "64k": dict(nz=1024, n=1024, nscan=65536, ndet=128, nprb=128)}
LARGE_ITERS = {"1024": 100, "2048": 100, "64k": 32}
# reconstruct's target on LARGE["1024"]: the reference's deep slab row.
LARGE_TARGET = 1e-5
LARGE_MAX_SEGMENTS = 16
# Positions per plain-version chunk at one mode: 1 GiB of frames.
LARGE_CHUNK = 8192
# Frame scratch (MiB) at which grad_fused's object scatter must give the
# same bits.
LARGE_BUDGETS = (512, 32)
# Peak extra memory of a large run: the frame scratch beside this many
# object-sized complex64 arrays (the solver's vectors and the scatter's
# running sums in double); at 1024^2 that is under the 1 GiB of data, so a
# data-sized temporary shows.
LARGE_OBJECTS = 24


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (asserts vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def median_ms(torch, fn, reps: int) -> float:
    """Median of ``reps`` synchronised calls, timed with CUDA events (the
    benchmark's own timer is a method of its harness, with a warm-up
    call)."""
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


def rel_err(torch, a, b):
    """(max|a - b| / max|b|, max|a - b|) after a synchronise."""
    torch.cuda.synchronize()
    abs_err = float((a - b).abs().max())
    return abs_err / float(b.abs().max()), abs_err


def compare_grad(torch, fused, args, ndet, model, base=None):
    """grad_fused against its plain version: (grad err, minf err, abs)."""
    g_k, f_k = fused.grad_fused(*args, ndet, model, base=base)
    g_r, f_r = fused.grad_fused_reference(*args, ndet, model, base=base)
    g_err, abs_err = rel_err(torch, g_k, g_r)
    f_err = abs(float(f_k) - float(f_r)) / abs(float(f_r))
    check(bool(torch.isfinite(g_k).all()) and g_err <= GRAD_TOL
          and f_err <= MINF_TOL, ("grad_fused", model, g_err, f_err))
    return g_err, f_err, abs_err


def compare_fwd(torch, fused, psi, scan_i, prb, ndet, base=None):
    """fwd (complex and split views) against its plain version."""
    out = fused.fwd(psi, scan_i, prb, ndet, base=base)
    re, im = fused.fwd(psi, scan_i, prb, ndet, base=base, split_out=True)
    ref = fused.fwd_reference(psi, scan_i, prb, ndet, base=base)
    err, abs_err = rel_err(torch, out, ref)
    check(bool(torch.isfinite(out).all()) and err <= FAR_TOL
          and torch.equal(torch.complex(re, im), out), ("fwd", err))
    return err, abs_err


def compare_minf(torch, fused, args, ndet, model, base=None):
    f_k = float(fused.minf_fused(*args, ndet, model, base=base))
    f_r = float(fused.minf_fused_reference(*args, ndet, model, base=base))
    err = abs(f_k - f_r) / abs(f_r)
    check(math.isfinite(f_k) and err <= MINF_TOL, ("minf_fused", model, err))
    return err, abs(f_k - f_r)


def compare_grad_prb(torch, fused, args, ndet, model):
    """grad_prb_fused against its plain version, and bitwise repeatable:
    (grad err, minf err, abs err)."""
    g_k, f_k = fused.grad_prb_fused(*args, ndet, model)
    g_2, f_2 = fused.grad_prb_fused(*args, ndet, model)
    g_r, f_r = fused.grad_prb_fused_reference(*args, ndet, model)
    g_err, abs_err = rel_err(torch, g_k, g_r)
    f_err = abs(float(f_k) - float(f_r)) / abs(float(f_r))
    check(bool(torch.isfinite(g_k).all()) and g_err <= GRAD_TOL
          and f_err <= MINF_TOL, ("grad_prb_fused", model, g_err, f_err))
    check(torch.equal(g_k, g_2) and float(f_k) == float(f_2),
          "grad_prb_fused is not bitwise repeatable")
    return g_err, f_err, abs_err


def compare_adjoints(torch, fused, far, scan_i, prb, psi):
    """adj and adj_probe against their plain versions (both also bitwise
    repeatable): ((adj err, abs), (adj_probe err, abs))."""
    nz, n = psi.shape[-2:]
    a_k = fused.adj(far, scan_i, prb, nz, n)
    check(torch.equal(a_k, fused.adj(far, scan_i, prb, nz, n)),
          "adj is not bitwise repeatable")
    a_err = rel_err(torch, a_k, fused.adj_reference(far, scan_i, prb, nz, n))
    p_k = fused.adj_probe(far, scan_i, psi, prb.shape[-1])
    p_2 = fused.adj_probe(far, scan_i, psi, prb.shape[-1])
    p_err = rel_err(torch, p_k, fused.adj_probe_reference(far, scan_i, psi,
                                                          prb.shape[-1]))
    check(bool(torch.isfinite(a_k).all()) and a_err[0] <= GRAD_TOL,
          ("adj", a_err))
    check(bool(torch.isfinite(p_k).all()) and p_err[0] <= GRAD_TOL,
          ("adj_probe", p_err))
    check(torch.equal(p_k, p_2), "adj_probe is not bitwise repeatable")
    return a_err, p_err


def compare_variant(torch, fused, args, ndet, model, base, far, variant):
    """One forced variant of grad_fused, minf_fused and fwd (with ``base``),
    grad_prb_fused, and adj, adj_probe, adj_residual and fwd_quad_stats (on
    ``far``) against the plain versions; every objective, the two probe
    sums, fwd's farplane, the statistics planes and the object scatters of
    adj, grad_fused and adj_residual bitwise repeatable. With the 'fft'
    variant the three objectives are one number, bit for bit (a line search
    compares them), and fwd's farplane is the one minf_fused forms inside:
    minf_fused of zeros on it as the base is minf_fused's objective, bit for
    bit; without a base it is also the direction farplane fwd_quad_stats
    forms: its statistics of psi on fwd(psi) are a == b == c, bit for bit.
    Returns the relative errors {kernel: (value err, objective err)}."""
    psi, data, scan_i, prb = args
    nprb = prb.shape[-1]
    nz, n = psi.shape[-2:]

    def twice(fn):
        return fn(), fn()

    (g_k, f_k), (g_2, f_2) = twice(lambda: fused._grad_fused_cuda(
        *args, ndet, model, base, variant=variant))
    g_r, f_r = fused.grad_fused_reference(*args, ndet, model, base=base)
    m_k, m_2 = twice(lambda: fused._minf_fused_cuda(
        *args, ndet, model, base, variant=variant))
    (q_k, h_k), (q_2, h_2) = twice(lambda: fused._grad_prb_fused_cuda(
        *args, ndet, model, variant=variant))
    q_r, h_r = fused.grad_prb_fused_reference(*args, ndet, model)
    p_k, p_2 = twice(lambda: fused._adj_probe_cuda(far, scan_i, psi, nprb,
                                                   variant=variant))
    p_r = fused.adj_probe_reference(far, scan_i, psi, nprb)
    a_k, a_2 = twice(lambda: fused._adj_cuda(far, scan_i, prb, nz, n,
                                             variant=variant))
    a_r = fused.adj_reference(far, scan_i, prb, nz, n)
    o_k, o_2 = twice(lambda: fused._fwd_cuda(psi, scan_i, prb, ndet, base,
                                             variant=variant))
    o_r = fused.fwd_reference(psi, scan_i, prb, ndet, base=base)
    (r_k, s_k), (r_2, s_2) = twice(lambda: fused._adj_residual_cuda(
        far, data, scan_i, prb, nz, n, model, variant=variant))
    r_r, s_r = fused.adj_residual_reference(far, data, scan_i, prb, nz, n,
                                            model)
    x_k, x_2 = twice(lambda: fused._fwd_quad_stats_cuda(
        psi, scan_i, prb, far, variant=variant))
    x_r = fused.fwd_quad_stats_reference(psi, scan_i, prb, far)

    def obj_err(got, ref):
        return abs(float(got) - float(ref)) / abs(float(ref))

    errs = {"grad_fused": (rel_err(torch, g_k, g_r)[0], obj_err(f_k, f_r)),
            "minf_fused": (0.0, obj_err(m_k, f_r)),
            "grad_prb_fused": (rel_err(torch, q_k, q_r)[0],
                               obj_err(h_k, h_r)),
            "adj": (rel_err(torch, a_k, a_r)[0], 0.0),
            "adj_probe": (rel_err(torch, p_k, p_r)[0], 0.0),
            "fwd": (rel_err(torch, o_k, o_r)[0], 0.0),
            "adj_residual": (rel_err(torch, r_k, r_r)[0], obj_err(s_k, s_r)),
            "fwd_quad_stats": (max(rel_err(torch, x, r)[0]
                                   for x, r in zip(x_k, x_r)), 0.0)}
    for name, (err, f_err) in errs.items():
        check(err <= GRAD_TOL and f_err <= MINF_TOL,
              (name, variant, model, err, f_err))
    check(all(bool(torch.isfinite(x).all())
              for x in (g_k, q_k, a_k, p_k, o_k, r_k, *x_k)),
          ("not finite", variant))
    check(float(f_k) == float(f_2) and float(m_k) == float(m_2)
          and float(h_k) == float(h_2) and torch.equal(q_k, q_2)
          and torch.equal(p_k, p_2) and torch.equal(o_k, o_2)
          and float(s_k) == float(s_2) and torch.equal(a_k, a_2)
          and torch.equal(g_k, g_2) and torch.equal(r_k, r_2)
          and all(torch.equal(x, y) for x, y in zip(x_k, x_2)),
          f"variant {variant}: an objective, a probe sum, the farplane, the "
          "statistics or an object scatter are not bitwise repeatable")
    if variant == "fft":
        check(float(m_k) == float(f_k) and (base is not None
                                            or float(h_k) == float(f_k)),
              ("the 'fft' objectives differ", float(f_k), float(m_k),
               float(h_k)))
        via = fused._minf_fused_cuda(torch.zeros_like(psi), data, scan_i,
                                     prb, ndet, model, o_k, variant="fft")
        check(float(via) == float(m_k),
              ("minf_fused on fwd's farplane differs", float(via),
               float(m_k)))
        if base is None:
            equal_stats(torch, fused._fwd_quad_stats_cuda(
                psi, scan_i, prb, o_k, variant="fft"), scan_i)
    return errs


def equal_stats(torch, stats, scan_i):
    """a == b == c bit for bit on every valid frame: fwd_quad_stats of a
    direction on the farplane fwd stored for it (the same forward half)."""
    a, b, c = stats
    valid = scan_i[..., 0] >= 0
    check(torch.equal(a[valid], b[valid]) and torch.equal(b[valid], c[valid]),
          ("fwd_quad_stats of x on fwd(x): a, b, c differ",
           float((a - c)[valid].abs().max())))


def fwd_feeds_minf(torch, fused, psi, data, scan_i, prb, ndet, base):
    """minf_fused of zeros on ``base`` (the farplane ``fwd`` stored for
    ``psi``, complex or split) and minf_fused of ``psi``: on 'fft' the same
    number bit for bit. Returns it."""
    direct = float(fused.minf_fused(psi, data, scan_i, prb, ndet,
                                    "gaussian"))
    via = float(fused.minf_fused(torch.zeros_like(psi), data, scan_i, prb,
                                 ndet, "gaussian", base=base))
    check(fused.fwd.variant == fused.minf_fused.variant == "fft"
          and via == direct, ("fwd's farplane into minf_fused", via, direct,
                              fused.fwd.variant, fused.minf_fused.variant))
    return via


def show_errs(errs) -> str:
    return ", ".join(f"{k} {e:.2e}/{f:.2e}" for k, (e, f) in errs.items())


def in_turns_ms(torch, timer, label, new_fn, old_fn, reps=5):
    """(new ms, old ms) of two kernels of one function (the 'fft' and the
    'gemm' variant, or the tile and the atomic scatter):
    ``reps`` back-to-back launches of each, in the order old, new, new,
    old, each run between two synchronises (the port's ``utils.Timer``);
    the two runs of a kernel are averaged."""
    for fn in (new_fn, old_fn):
        fn()  # warm-up
    for key, fn in (("old 1", old_fn), ("new 1", new_fn),
                    ("new 2", new_fn), ("old 2", old_fn)):
        with timer(f"{label} {key}"):
            for _ in range(reps):
                fn()
    t = timer.times
    return tuple(1e3 * (t[f"{label} {v} 1"] + t[f"{label} {v} 2"])
                 / (2 * reps) for v in ("new", "old"))


def grad_fused_bodies(torch, fused, timer, g, psi, data, scan_i, prb, base,
                      bound_ms, card):
    """grad_fused's two FFT bodies at the headline (one mode, 128^2): the
    fused one that the shapes pick and the shared-memory one forced with
    ``variant='fft_smem'``. The same gradient and objective bit for bit for
    both likelihoods, without and with a base, at 512 and 32 MiB of frame
    scratch, on a scan with masked and out-of-bounds positions, and the
    fused body's objective is minf_fused's; then the two in turns without
    and with a base (the whole call, and the frame kernels alone under the
    profiler). Returns {case: (fused ms, shared-memory ms)}."""
    odd = scan_i.clone()
    odd[0, 5, 0] = -1        # a masked dummy
    odd[0, 11, 1] = g.n      # a window past the right edge
    odd[0, 17, 0] = g.nz     # and one past the bottom
    for model in ("gaussian", "poisson"):
        for b in (None, base):
            for mib in (512, 32):
                chunk = mib * 2**20 // (g.nmodes * g.nprb**2 * 8)
                got, f_got = fused._grad_fused_cuda(
                    psi, data, odd, prb, g.ndet, model, b, chunk=chunk)
                check(fused.grad_fused.body == "fft_regs",
                      fused.grad_fused.body)
                old, f_old = fused._grad_fused_cuda(
                    psi, data, odd, prb, g.ndet, model, b,
                    variant="fft_smem", chunk=chunk)
                check(fused.grad_fused.body == "fft_smem",
                      fused.grad_fused.body)
                f_m = fused.minf_fused(psi, data, odd, prb, g.ndet, model,
                                       base=b)
                check(torch.equal(got, old) and float(f_got) == float(f_old)
                      == float(f_m),
                      ("grad_fused's bodies differ", model, b is not None,
                       mib, float(f_got), float(f_old), float(f_m)))
    args = (psi, data, scan_i, prb, g.ndet, "gaussian")
    turns = {}
    for case, b in (("no base", None), ("base", base)):
        turns[case] = in_turns_ms(
            torch, timer, f"grad_fused bodies {case}",
            lambda: fused._grad_fused_cuda(*args, b),
            lambda: fused._grad_fused_cuda(*args, b, variant="fft_smem"))
        alone = {}
        for body, kw in (("fft_regs", {}), ("fft_smem",
                                            {"variant": "fft_smem"})):
            wall, _, top = device_busy(torch, lambda: [
                fused._grad_fused_cuda(*args, b, **kw) for _ in range(5)])
            kernel = ("grad_fused_regs_kernel" if body == "fft_regs"
                      else "grad_fused_fft_kernel")
            alone[body] = sum(ms for k, ms in top.items() if kernel in k) / 5
        turns[case + ", frame kernel alone"] = (alone["fft_regs"],
                                                alone["fft_smem"])
    log("kernel", f"grad_fused's two FFT bodies at {g}: the fused body "
        "equals the forced shared-memory body bit for bit (gradient and "
        "objective, gaussian and poisson, without and with a base, at 512 "
        "and 32 MiB of frame scratch, masked and out-of-bounds positions in "
        "the scan), and its objective is minf_fused's; in turns (5 "
        "back-to-back calls each, smem, fused, fused, smem): " + ", ".join(
            f"{k} {new:.3f} / smem {old:.3f} ms ({new / old:.3f}x)"
            for k, (new, old) in turns.items())
        + f"; the operator's bound {bound_ms:.3f} ms ("
        f"{100 * bound_ms / turns['no base'][0]:.1f}% of it reached, smem "
        f"{100 * bound_ms / turns['no base'][1]:.1f}%); on {card}")
    return turns


def minf_fused_bodies(torch, fused, timer, g, psi, data, scan_i, prb, base,
                      card):
    """minf_fused's two FFT bodies at the headline (one mode, 128^2): the
    fused one that the shapes pick and the shared-memory one forced with
    ``variant='fft_smem'``. The same objective bit for bit, and grad_fused's
    on its fused body, for both likelihoods, without and with a base, with
    the data prefetch (all the positions) and without it (an unaligned copy
    of the first CONFIG3_FRAMES positions' data), on a scan with masked and
    out-of-bounds positions; then the two in turns at all the positions and
    at the first CONFIG3_FRAMES (the joint cell's launch), without and with
    a base, beside the operator's bound, and each kernel alone under the
    profiler without a base. Returns {case: (fused ms, shared-memory ms,
    bound ms)}."""
    odd = scan_i.clone()
    odd[0, 5, 0] = -1        # a masked dummy
    odd[0, 11, 1] = g.n      # a window past the right edge
    odd[0, 17, 0] = g.nz     # and one past the bottom
    few = CONFIG3_FRAMES
    store = torch.empty(g.ntheta * few * g.ndet**2 + 1, dtype=data.dtype,
                        device=data.device)
    unaligned = store[1:].view(g.ntheta, few, g.ndet, g.ndet)
    unaligned.copy_(data[:, :few])
    check(not fused._fft_prefetch(1, unaligned), "aligned copy")
    for model in ("gaussian", "poisson"):
        for b in (None, base):
            for dat, sc, bb in (
                    (data, odd, b),
                    (unaligned, odd[:, :few], None if b is None
                     else b[:, :few])):
                got = fused._minf_fused_cuda(psi, dat, sc, prb, g.ndet, model,
                                             bb)
                check(fused.minf_fused.body == "fft_regs",
                      fused.minf_fused.body)
                old = fused._minf_fused_cuda(psi, dat, sc, prb, g.ndet, model,
                                             bb, variant="fft_smem")
                check(fused.minf_fused.body == "fft_smem",
                      fused.minf_fused.body)
                f_g = fused._grad_fused_cuda(psi, dat, sc, prb, g.ndet,
                                             model, bb)[1]
                check(float(got) == float(old) == float(f_g),
                      ("minf_fused's bodies differ", model, b is not None,
                       dat is data, float(got), float(old), float(f_g)))
    del store, unaligned
    turns, alone = {}, {}
    for frames in (g.nscan, few):
        sc, dat = scan_i[:, :frames], data[:, :frames]
        for case, b in (("no base", None), ("base", base)):
            bb = None if b is None else b[:, :frames]
            args = (psi, dat, sc, prb, g.ndet, "gaussian", bb)
            new_ms, old_ms = in_turns_ms(
                torch, timer, f"minf_fused bodies {frames} {case}",
                lambda: fused._minf_fused_cuda(*args),
                lambda: fused._minf_fused_cuda(*args, variant="fft_smem"))
            moved = nbytes(psi, prb, dat, sc) + 4 + (
                0 if bb is None else nbytes(bb))
            turns[f"{frames} frames, {case}"] = (
                new_ms, old_ms,
                bound(fft_flops(sc, g.nmodes, g.ndet, 1), moved)[0])
        args = (psi, dat, sc, prb, g.ndet, "gaussian", None)
        for body, variant, kernel in (
                ("fft_regs", None, "minf_fused_regs_kernel"),
                ("fft_smem", "fft_smem", "minf_fused_fft_kernel")):
            _, _, top = device_busy(torch, lambda: [
                fused._minf_fused_cuda(*args, variant=variant)
                for _ in range(5)])
            alone[frames, body] = sum(ms for k, ms in top.items()
                                      if kernel in k) / 5
        turns[f"{frames} frames, kernel alone"] = (
            alone[frames, "fft_regs"], alone[frames, "fft_smem"],
            turns[f"{frames} frames, no base"][2])
    log("kernel", f"minf_fused's two FFT bodies at {g}: the fused body's "
        "objective equals the forced shared-memory body's and grad_fused's "
        "bit for bit (gaussian and poisson, without and with a base, with "
        f"the data prefetch and without it on {few} positions, masked and "
        "out-of-bounds positions in the scan); in turns (5 back-to-back "
        "calls each, smem, fused, fused, smem): " + ", ".join(
            f"{k} {new:.3f} / smem {old:.3f} ms ({new / old:.3f}x; bound "
            f"{bnd:.3f} ms, {100 * bnd / new:.1f}% of it reached, smem "
            f"{100 * bnd / old:.1f}%)" for k, (new, old, bnd) in turns.items())
        + f"; on {card}")
    return turns


def kernel_report(cuda_build, report: str, pattern: str) -> dict:
    """nvcc's register and spill report of the one kernel instantiation
    whose mangled name contains ``pattern``."""
    found = [v for k, v in cuda_build.kernel_reports(report).items()
             if pattern in k]
    check(len(found) == 1, (pattern, len(found)))
    return found[0]


def compare_adj_residual(torch, fused, far, data, scan_i, prb, nz, n,
                         model):
    """adj_residual against its plain version, its objective bitwise
    repeatable: (grad err, minf err, abs err)."""
    g_k, f_k = fused.adj_residual(far, data, scan_i, prb, nz, n, model)
    f_2 = fused.adj_residual(far, data, scan_i, prb, nz, n, model)[1]
    g_r, f_r = fused.adj_residual_reference(far, data, scan_i, prb, nz, n,
                                            model)
    g_err, abs_err = rel_err(torch, g_k, g_r)
    f_err = abs(float(f_k) - float(f_r)) / abs(float(f_r))
    check(bool(torch.isfinite(g_k).all()) and g_err <= GRAD_TOL
          and f_err <= MINF_TOL, ("adj_residual", model, g_err, f_err))
    check(float(f_k) == float(f_2), "adj_residual's objective is not "
          "bitwise repeatable")
    return g_err, f_err, abs_err


def compare_quad_stats(torch, fused, x, scan_i, p, fpsi):
    """fwd_quad_stats against its plain version (each of a, b, c within
    FAR_TOL of its scale) and bitwise repeatable: (worst err, abs err)."""
    got = fused.fwd_quad_stats(x, scan_i, p, fpsi)
    again = fused.fwd_quad_stats(x, scan_i, p, fpsi)
    ref = fused.fwd_quad_stats_reference(x, scan_i, p, fpsi)
    errs = [rel_err(torch, t, r) for t, r in zip(got, ref)]
    check(all(bool(torch.isfinite(t).all()) for t in got)
          and max(e for e, _ in errs) <= FAR_TOL, ("fwd_quad_stats", errs))
    check(all(torch.equal(t, u) for t, u in zip(got, again)),
          "fwd_quad_stats is not bitwise repeatable")
    return max(e for e, _ in errs), max(a for _, a in errs)


def compare_ls(torch, linesearch, fpsi, fd, data, model):
    """ls_objectives at LS_STEPS against its plain version, each value
    within MINF_TOL, bitwise repeatable: (worst err, its abs err)."""
    launches = linesearch.ls_objectives.launches
    v_k = linesearch.ls_objectives(fpsi, fd, data, LS_STEPS, model)
    v_2 = linesearch.ls_objectives(fpsi, fd, data, LS_STEPS, model)
    check(linesearch.ls_objectives.launches == launches + 2,
          "ls_objectives did not launch its kernel")
    v_r = linesearch.ls_objectives_reference(fpsi, fd, data, LS_STEPS,
                                             model)
    torch.cuda.synchronize()
    err = float(((v_k - v_r).abs() / v_r.abs()).max())
    check(bool(torch.isfinite(v_k).all()) and err <= MINF_TOL,
          ("ls_objectives", model, err))
    check(torch.equal(v_k, v_2), "ls_objectives is not bitwise repeatable")
    return err, float((v_k - v_r).abs().max())


def compare_at_scale(torch, fused, g, psi, data, scan_i, prb, base, chunk):
    """The kernels at full size, where the base's and the farplane's float
    offsets pass 2**31, against their plain versions taken over chunks of
    positions and summed (grad_fused, minf_fused) or compared chunk by
    chunk (fwd): the plain farplane of every position at once would need
    several base-sized temporaries. ``base`` is an (re, im) view pair, the
    form the frameless path hands the kernels; adj and adj_probe take it as
    their farplane. Returns {kernel: (worst
    relative error, worst absolute error)} over the cases checked."""
    parts = [slice(i, min(i + chunk, g.nscan))
             for i in range(0, g.nscan, chunk)]

    def sub(b, c):
        return None if b is None else tuple(x[:, c] for x in b)

    errs = {"grad_fused": [], "minf_fused": [], "fwd": []}
    for b in (None, base):
        g_k, f_k = fused.grad_fused(psi, data, scan_i, prb, g.ndet,
                                    "gaussian", base=b)
        g_r, f_r = torch.zeros_like(g_k), 0.0
        for c in parts:
            g_c, f_c = fused.grad_fused_reference(
                psi, data[:, c], scan_i[:, c], prb, g.ndet, "gaussian",
                base=sub(b, c))
            g_r += g_c
            f_r += float(f_c)
        g_err, g_abs = rel_err(torch, g_k, g_r)
        f_err = abs(float(f_k) - f_r) / abs(f_r)
        check(bool(torch.isfinite(g_k).all()) and g_err <= GRAD_TOL
              and f_err <= MINF_TOL,
              ("grad_fused at scale", b is not None, g_err, f_err))
        errs["grad_fused"].append((g_err, g_abs))
        del g_k, g_r

        m_k = float(fused.minf_fused(psi, data, scan_i, prb, g.ndet,
                                     "gaussian", base=b))
        m_r = sum(float(fused.minf_fused_reference(
            psi, data[:, c], scan_i[:, c], prb, g.ndet, "gaussian",
            base=sub(b, c))) for c in parts)
        m_err = abs(m_k - m_r) / abs(m_r)
        check(math.isfinite(m_k) and m_err <= MINF_TOL,
              ("minf_fused at scale", b is not None, m_err))
        errs["minf_fused"].append((m_err, abs(m_k - m_r)))

        re, im = fused.fwd(psi, scan_i, prb, g.ndet, base=b, split_out=True)
        abs_err = scale = 0.0
        for c in parts:
            ref = fused.fwd_reference(psi, scan_i[:, c], prb, g.ndet,
                                      base=sub(b, c))
            diff = torch.complex(re[:, c] - ref.real, im[:, c] - ref.imag)
            abs_err = max(abs_err, float(diff.abs().max()))
            scale = max(scale, float(ref.abs().max()))
            del ref, diff
        check(bool(torch.isfinite(re).all() and torch.isfinite(im).all())
              and abs_err <= FAR_TOL * scale,
              ("fwd at scale", b is not None, abs_err / scale))
        errs["fwd"].append((abs_err / scale, abs_err))
        del re, im
    # adj and adj_probe on the base as a farplane (the 'fft' variant at this
    # size).
    far = fused._base_complex(base)
    a_k = fused.adj(far, scan_i, prb, g.nz, g.n)
    check(fused.adj.variant == "fft", fused.adj.variant)
    a_r = torch.zeros_like(a_k)
    for c in parts:
        a_r += fused.adj_reference(far[:, c], scan_i[:, c], prb, g.nz, g.n)
    errs["adj"] = [rel_err(torch, a_k, a_r)]
    check(bool(torch.isfinite(a_k).all())
          and errs["adj"][0][0] <= GRAD_TOL, ("adj at scale", errs["adj"]))
    del a_k, a_r
    p_k = fused.adj_probe(far, scan_i, psi, g.nprb)
    p_r = sum(fused.adj_probe_reference(far[:, c], scan_i[:, c], psi, g.nprb)
              for c in parts)
    errs["adj_probe"] = [rel_err(torch, p_k, p_r)]
    check(bool(torch.isfinite(p_k).all())
          and errs["adj_probe"][0][0] <= GRAD_TOL
          and fused.adj_probe.variant == fused.grad_fused.variant == "fft",
          ("adj_probe at scale", errs["adj_probe"]))
    check(torch.equal(p_k, fused.adj_probe(far, scan_i, psi, g.nprb)),
          "adj_probe at scale is not bitwise repeatable")
    return {k: (max(e for e, _ in v), max(a for _, a in v))
            for k, v in errs.items()}


def compare_hybrid(torch, kernels, psi, scan_i, prb, frames):
    """gather_probe_mul, scatter_conj_probe and adj_probe_reduce against
    their plain versions; ``frames`` (t, s, m, p, p), possibly a strided
    crop, feeds the two adjoints. All three must be bitwise repeatable,
    the scatter on its tile kernel. Returns {kernel: (relative error,
    absolute error)}."""
    nz, n = psi.shape[-2:]
    g_k = kernels.gather_probe_mul(psi, scan_i, prb)
    s_k = kernels.scatter_conj_probe(frames, scan_i, prb, nz, n)
    p_k = kernels.adj_probe_reduce(frames, scan_i, psi)
    errs = {
        "gather_probe_mul": rel_err(
            torch, g_k, kernels.gather_probe_mul_reference(psi, scan_i, prb)),
        "scatter_conj_probe": rel_err(
            torch, s_k, kernels.scatter_conj_probe_reference(
                frames, scan_i, prb, nz, n)),
        "adj_probe_reduce": rel_err(
            torch, p_k, kernels.adj_probe_reduce_reference(frames, scan_i,
                                                           psi)),
    }
    for name, out in (("gather_probe_mul", g_k), ("scatter_conj_probe", s_k),
                      ("adj_probe_reduce", p_k)):
        check(bool(torch.isfinite(out).all())
              and errs[name][0] <= GRAD_TOL, (name, errs[name]))
    check(torch.equal(g_k, kernels.gather_probe_mul(psi, scan_i, prb)),
          "gather_probe_mul is not bitwise repeatable")
    check(torch.equal(p_k, kernels.adj_probe_reduce(frames, scan_i, psi)),
          "adj_probe_reduce is not bitwise repeatable")
    check(kernels.scatter_conj_probe.variant == "tile",
          kernels.scatter_conj_probe.variant)
    check(torch.equal(s_k, kernels.scatter_conj_probe(frames, scan_i, prb,
                                                      nz, n)),
          "scatter_conj_probe is not bitwise repeatable")
    return errs


def scatter_blocks_per_sm(launch, kernels, device_index, nmodes) -> int:
    """Resident blocks per SM of the tile scatter's instantiation for
    ``nmodes`` modes."""
    return launch.blocks_per_sm(
        "scatter_conj_probe", "tk_scatter_conj_probe_blocks_per_sm",
        device_index, kernels.scatter_mode_chunk(nmodes))


def scatter_entry(kernels, nmodes: int) -> str:
    """Part of the mangled name of the tile kernel's instantiation for
    ``nmodes`` modes, for the compiler's report."""
    return (f"scatter_conj_probe_tile_kernelILi"
            f"{kernels.scatter_mode_chunk(nmodes)}EE")


def scatter_as_tile(torch, kernels, frames, scan_i, prb, nz, n):
    """scatter_conj_probe's tile kernel (as launched) on ``frames`` (any
    strides): bitwise repeatable, the same bits with every chunk of the
    scan walked (no chunk skip), within GRAD_TOL of scale of the plain
    version and within SCATTER_ORDER_TOL of the forced atomic kernel it
    replaced; with every position masked exactly zero (the output is not
    zeroed before the kernel, so a pixel it missed would show). Returns
    (error against the plain version, against the atomic kernel)."""
    got = kernels.scatter_conj_probe(frames, scan_i, prb, nz, n)
    check(kernels.scatter_conj_probe.variant == "tile",
          kernels.scatter_conj_probe.variant)
    check(torch.equal(got, kernels.scatter_conj_probe(frames, scan_i, prb, nz,
                                                      n)),
          ("scatter_conj_probe is not bitwise repeatable",
           tuple(frames.shape), nz, n))
    check(torch.equal(got, kernels._scatter_conj_probe_cuda(
        frames, scan_i, prb, nz, n, skip=False)),
          ("scatter_conj_probe: the chunk skip changed the bits",
           tuple(frames.shape), nz, n))
    ref = kernels.scatter_conj_probe_reference(frames, scan_i, prb, nz, n)
    old = kernels._scatter_conj_probe_cuda(frames, scan_i, prb, nz, n,
                                           variant="atomic")
    errs = (rel_err(torch, got, ref)[0], rel_err(torch, got, old)[0])
    check(bool(torch.isfinite(got).all()) and errs[0] <= GRAD_TOL
          and errs[1] <= SCATTER_ORDER_TOL,
          ("scatter_conj_probe", tuple(frames.shape), nz, n, errs))
    masked = scan_i.clone()
    masked[..., 0] = -1
    zero = kernels.scatter_conj_probe(frames, masked, prb, nz, n)
    check(float(zero.abs().max()) == 0.0,
          "scatter_conj_probe: every position masked is not zero")
    return errs


def gather_repeatable(torch, kernels, psi, scan_i, prb):
    """gather_probe_mul's persistent kernel: within GRAD_TOL of its plain
    version, bitwise repeatable, every frame of a masked position zero.
    Returns the number of masked positions."""
    got = kernels.gather_probe_mul(psi, scan_i, prb)
    again = kernels.gather_probe_mul(psi, scan_i, prb)
    masked = scan_i[..., 0] < 0
    err = rel_err(torch, got, kernels.gather_probe_mul_reference(
        psi, scan_i, prb))[0]
    check(err <= GRAD_TOL, ("gather_probe_mul", tuple(prb.shape), err))
    check(torch.equal(got, again), "gather_probe_mul is not bitwise "
          "repeatable")
    check(not bool(masked.any()) or float(got[masked].abs().max()) == 0.0,
          "gather_probe_mul: a masked frame is not zero")
    return int(masked.sum())


def compare_hybrid_at_scale(torch, kernels, g, psi, scan_i, prb, frames,
                            chunk):
    """The three hybrid kernels at full size, where the nearplane's float
    offsets pass 2**31, against their plain versions taken over chunks of
    positions: compared chunk by chunk (gather_probe_mul) or summed over
    the chunks (the two adjoints). Returns {kernel: (relative error,
    absolute error)}."""
    parts = [slice(i, min(i + chunk, g.nscan))
             for i in range(0, g.nscan, chunk)]
    out = kernels.gather_probe_mul(psi, scan_i, prb)
    abs_err = scale = 0.0
    for c in parts:
        ref = kernels.gather_probe_mul_reference(psi, scan_i[:, c], prb)
        abs_err = max(abs_err, float((out[:, c] - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
        del ref
    check(bool(torch.isfinite(out).all()) and abs_err <= GRAD_TOL * scale,
          ("gather_probe_mul at scale", abs_err / scale))
    errs = {"gather_probe_mul": (abs_err / scale, abs_err)}
    del out
    s_k = kernels.scatter_conj_probe(frames, scan_i, prb, g.nz, g.n)
    check(kernels.scatter_conj_probe.variant == "tile"
          and torch.equal(s_k, kernels.scatter_conj_probe(frames, scan_i,
                                                          prb, g.nz, g.n)),
          "scatter_conj_probe at scale is not bitwise repeatable")
    s_r = sum(kernels.scatter_conj_probe_reference(
        frames[:, c], scan_i[:, c], prb, g.nz, g.n) for c in parts)
    p_k = kernels.adj_probe_reduce(frames, scan_i, psi)
    p_r = sum(kernels.adj_probe_reduce_reference(
        frames[:, c], scan_i[:, c], psi) for c in parts)
    for name, got, ref in (("scatter_conj_probe", s_k, s_r),
                           ("adj_probe_reduce", p_k, p_r)):
        errs[name] = rel_err(torch, got, ref)
        check(bool(torch.isfinite(got).all())
              and errs[name][0] <= GRAD_TOL, (name + " at scale",
                                                errs[name]))
    return errs


def compare_lbfgs(torch, lbfgs, dev):
    """The L-BFGS direction's kernels at the headline object (512^2,
    complex64) and m = 8: each against its plain version on CPU copies (the
    test's tolerances), each bitwise repeatable, the combination's pair
    stored in its slot; then each timed (median of 20, CUDA events) beside
    its plain version on the card and the compact plain form: the Gram as
    the two operations that form s and y into a contiguous ring and one
    matrix product, the combination as the pair's two copies into its slot,
    the coefficients' copy to the card and one matrix-vector product, each
    in float32 and in float64. Returns ({name: (max abs err, ms, plain
    ms)}, {name: bound}, {name: {'float32': (ms, rel err), 'float64': (ms,
    rel err)}})."""
    m, gamma, slot, c_g = LBFGS_M, 0.625, 3, 0.875
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rand(*lead):
        return torch.randn(lead + LBFGS_SHAPE, generator=gen, device=dev,
                           dtype=torch.complex64)

    def bits(x):
        return torch.view_as_real(x).view(torch.int32)

    S, Y, g, gp, dp = rand(m), rand(m), rand(), rand(), rand()
    cpu = [x.cpu() for x in (S, Y, g, gp, dp)]
    prods = lbfgs.lbfgs_gram(S, Y, g, gp, dp, gamma)
    check(torch.equal(prods, lbfgs.lbfgs_gram(S, Y, g, gp, dp, gamma)),
          "lbfgs_gram: two calls differ")
    plain = lbfgs.lbfgs_gram_reference(*cpu, gamma)
    gram_err = float((prods.cpu() - plain).abs().max())
    check(torch.allclose(prods.cpu(), plain, rtol=1e-10, atol=1e-8),
          ("lbfgs_gram", gram_err))
    a = [0.5 - 0.1 * k for k in range(m)]
    b = [0.2 * k - 0.7 for k in range(m)]
    S2, Y2 = S.clone(), Y.clone()
    d = lbfgs.lbfgs_combine(S, Y, g, gp, dp, gamma, slot, c_g, a, b)
    d2 = lbfgs.lbfgs_combine(S2, Y2, g, gp, dp, gamma, slot, c_g, a, b)
    check(torch.equal(bits(d), bits(d2)) and torch.equal(bits(S), bits(S2))
          and torch.equal(bits(Y), bits(Y2)), "lbfgs_combine: two calls "
          "differ")
    d_plain = lbfgs.lbfgs_combine_reference(*cpu, gamma, slot, c_g, a, b)
    check(torch.equal(S[slot].cpu(), cpu[0][slot])
          and torch.equal(Y[slot].cpu(), cpu[1][slot]),
          "lbfgs_combine: the pair stored otherwise than the plain version")
    comb_err = float((d.cpu() - d_plain).abs().max())
    # The same sums in double but for contracted multiply-adds: at most an
    # ulp apart after the one rounding in complex64.
    size = c_g + sum(map(abs, a)) + sum(map(abs, b))
    tol = 4 * torch.finfo(torch.float32).eps * size * max(
        float(x.abs().max()) for x in cpu)
    check(comb_err <= tol, ("lbfgs_combine", comb_err, tol))

    # The compact plain form: rows S_0..S_{m-1}, Y_0..Y_{m-1}, g, s, y.
    ring = torch.cat([S, Y, g[None], torch.empty_like(S[:2])])
    rows = torch.view_as_real(ring).reshape(2 * m + 3, -1)
    coeffs = a + b + [c_g]

    def form():
        torch.mul(dp, gamma, out=ring[2 * m + 1])
        torch.sub(g, gp, out=ring[2 * m + 2])

    def gram_plain(dtype):
        form()
        w = rows.to(dtype)
        return w[2 * m:] @ w.T

    def combine_plain(dtype):
        ring[slot], ring[m + slot] = ring[2 * m + 1], ring[2 * m + 2]
        c = torch.tensor(coeffs, dtype=dtype).to(dev)
        return torch.mv(rows[:2 * m + 1].T.to(dtype), -c).to(torch.float32)

    form()
    ref_d = -(c_g * g + sum(a[k] * ring[k] + b[k] * ring[m + k]
                            for k in range(m)))
    ref_prods = lbfgs.lbfgs_gram(S, Y, g, gp, dp, gamma)  # the pair stored
    compact = {"lbfgs_gram": {}, "lbfgs_combine": {}}
    for name, dtype in (("float32", torch.float32),
                        ("float64", torch.float64)):
        got = gram_plain(dtype).double()
        compact["lbfgs_gram"][name] = (
            median_ms(torch, lambda: gram_plain(dtype), 20),
            float((got - ref_prods).abs().max() / ref_prods.abs().max()))
        got = torch.view_as_complex(combine_plain(dtype).view(-1, 2))
        compact["lbfgs_combine"][name] = (
            median_ms(torch, lambda: combine_plain(dtype), 20),
            float((got - ref_d.reshape(-1)).abs().max()
                  / ref_d.abs().max()))
    results = {
        "lbfgs_gram": (gram_err, median_ms(torch, lambda: lbfgs.lbfgs_gram(
            S, Y, g, gp, dp, gamma), 20), median_ms(
            torch, lambda: lbfgs.lbfgs_gram_reference(S, Y, g, gp, dp,
                                                      gamma), 20)),
        "lbfgs_combine": (comb_err, median_ms(
            torch, lambda: lbfgs.lbfgs_combine(S, Y, g, gp, dp, gamma, slot,
                                               c_g, a, b), 20), median_ms(
            torch, lambda: lbfgs.lbfgs_combine_reference(
                S, Y, g, gp, dp, gamma, slot, c_g, a, b), 20))}
    # Bytes: the Gram reads the ring, g, g_prev and d_prev; the combination
    # reads the ring but the stored slot, g, g_prev and d_prev and writes d
    # and the pair.
    slot_bytes = nbytes(g)
    bounds = {"lbfgs_gram": bound(0.0, (2 * m + 3) * slot_bytes),
              "lbfgs_combine": bound(0.0, (2 * m + 4) * slot_bytes)}
    return results, bounds, compact


def fft_flops(scan_i, nmodes: int, ndet: int, dfts: int) -> float:
    """h100bench.roofline's FFT FLOPs of every valid (unmasked) frame of
    ``scan_i``."""
    return frame_flops(int((scan_i[..., 0] >= 0).sum()), nmodes, ndet, dfts)


def ls_flops(data, nmodes: int, steps: int) -> float:
    """fp32 operations of ls_objectives on ``data``'s pixels: a, b, c (12
    a mode), max(d, 0) and sqrt(d) (2), and per step two FMAs, the clamp,
    the square root (or logarithm), a difference, a square and the sum
    (9)."""
    return data.numel() * (12 * nmodes + 2 + 9 * steps)


def device_busy(torch, fn):
    """``fn()`` in h100bench.trace's profiler window, between two
    synchronises: (wall ms, the share of it in which the card ran a kernel,
    a copy or a set, {kernel: ms on the card} for the six that took the
    most). The profiler's own host work lengthens the wall time a little,
    so the share is a lower bound."""
    with trace.window(torch.cuda.synchronize) as held:
        fn()
    profile = held[0]
    check(profile is not None, "the profiler saw nothing run on the card")
    return (1e3 * profile.window_s, profile.busy_s / profile.window_s,
            {name: 1e3 * s for name, s in profile.device_ops[:6]})


def show_busy(iters, busy, plain_ms) -> str:
    """One line on a profiled window of ``iters`` iterations of a phase
    whose iterations took ``plain_ms`` each without the profiler."""
    wall_ms, share, top = busy
    busy_ms = share * wall_ms / iters
    return (f"the same, {iters} iterations under torch.profiler: the card "
            f"busy {busy_ms:.2f} ms/iter, {100 * busy_ms / plain_ms:.1f}% of "
            f"the {plain_ms:.2f} ms/iter measured without the profiler "
            f"({100 * share:.1f}% of the profiled {wall_ms / iters:.2f}); "
            "most device time: " + ", ".join(
                f"{k} {v / iters:.3f}" for k, v in top.items()) + " ms/iter")


def kernel_counters():
    """(the twelve kernels' wrappers, the hybrid tier's three next to last,
    then the L-BFGS direction's two; their plain versions): each keeps its
    count in ``launches``."""
    from tikejax_torch.ops import fused, kernels, lbfgs, linesearch

    return ([fused.grad_fused, fused.fwd, fused.minf_fused,
             fused.grad_prb_fused, fused.adj, fused.adj_probe,
             fused.adj_residual, fused.fwd_quad_stats,
             linesearch.ls_objectives, kernels.gather_probe_mul,
             kernels.scatter_conj_probe, kernels.adj_probe_reduce,
             lbfgs.lbfgs_gram, lbfgs.lbfgs_combine],
            [fused.grad_fused_reference, fused.fwd_reference,
             fused.minf_fused_reference, fused.grad_prb_fused_reference,
             fused.adj_reference, fused.adj_probe_reference,
             fused.adj_residual_reference, fused.fwd_quad_stats_reference,
             linesearch.ls_objectives_reference,
             kernels.gather_probe_mul_reference,
             kernels.scatter_conj_probe_reference,
             kernels.adj_probe_reduce_reference,
             lbfgs.lbfgs_gram_reference, lbfgs.lbfgs_combine_reference])


def body_delta(kernel, before) -> dict:
    """The launches of ``kernel`` (``fused.grad_fused``'s frame kernel or
    ``fused.minf_fused``) by body since ``before`` (a copy of its
    ``body_launches``), the bodies that ran only."""
    return {k: v - before[k] for k, v in kernel.body_launches.items()
            if v != before[k]}


def shape(gg, positions=None):
    """(angles, positions, modes, probe side) of one call on geometry
    ``gg`` (``positions`` of each angle where given)."""
    return (gg.ntheta, gg.nscan if positions is None else positions,
            gg.nmodes, gg.nprb)


def frame_launches(fused, t: int, s: int, m: int, p: int) -> int:
    """Frame-kernel launches of one grad_fused or adj_residual call on t
    angles of s positions, m modes of p^2: one a chunk of frames
    (fused.frame_chunks)."""
    return len(fused.frame_chunks(t, s, fused.frame_chunk(m, p)))


def sharded_problem(torch, g, seed: int, dev, perturb: float = 0.0):
    """(data, psi0 = ones, scan, probe) of geometry ``g`` from ``seed`` on
    ``dev``: every rank and the one-rank run make the same arrays. With
    ``perturb`` the probe gets complex Gaussian noise at that share of its
    maximum."""
    from tikejax_torch.models import make_problem

    gen = torch.Generator(device=dev).manual_seed(seed)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    if perturb:
        prb = prb + perturb * prb.abs().max() * torch.complex(
            torch.randn(g.prb_shape, generator=gen, device=dev),
            torch.randn(g.prb_shape, generator=gen, device=dev))
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64, device=dev)
    return data, psi0, scan, prb


def checksum(torch, *arrays):
    """float64 sums of the arrays (of |x| for complex ones), stacked."""
    return torch.stack([(x.abs() if x.is_complex() else x).double().sum()
                        for x in arrays])


def rank_checksum(torch, *arrays):
    """(this rank's checksum of the arrays, whether every rank's is the
    same: its all-reduced maximum and minimum are equal)."""
    import torch.distributed as dist

    mine = checksum(torch, *arrays)
    hi, lo = mine.clone(), mine.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return mine, torch.equal(hi, lo)


def sharded_job(rank, world, what, mesh_shape, geom, seed, kw, perturb=0.0):
    """A rank of phase 17 (a RankPool job; the ranks import this script as
    their main module, never jax). Builds the problem from ``seed``, checks
    with an all-reduced checksum that every rank built the same one, warms
    up, then runs ``run_sharded(**kw)`` (``what == 'run'``) or
    ``reconstruct(mesh=, **kw)`` (``'deep'``) between two synchronises,
    with every launch count and the collectives counted from zero; a
    'run' is then profiled for PROFILE_ITERS iterations."""
    import torch
    import torch.distributed as dist

    from tikejax_torch import Geometry
    from tikejax_torch.parallel import make_mesh, run_sharded, sharding
    from tikejax_torch.solvers import cg, reconstruct

    dev = torch.device("cuda", torch.cuda.current_device())
    g = Geometry(**geom)
    data, psi0, scan, prb = sharded_problem(torch, g, seed, dev, perturb)
    mine, same = rank_checksum(torch, data, scan, prb)
    mesh = make_mesh(mesh_shape, device_type="cuda")
    counters, plain = kernel_counters()
    run_kw = {k: v for k, v in kw.items()
              if k not in ("target_residual", "max_segments")}
    run_sharded(data, psi0, scan, prb, g, mesh, **dict(run_kw, piter=2))
    for fn in counters + plain + [cg.all_reduce]:
        fn.launches = 0
    cg.all_reduce.bytes, cg.all_reduce.sizes = 0, {}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    if what == "run":
        psi, prb_out, m = run_sharded(data, psi0, scan, prb, g, mesh, **kw)
    else:
        psi, prb_out, stages = reconstruct(data, psi0, scan, prb, g,
                                           mesh=mesh, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _, _, tsh, nsh, _, _ = sharding._layout(mesh)
    out = {"same_problem": same, "checksum": mine,
           "local": (g.ntheta // tsh, -(-g.nscan // nsh), g.nmodes, g.nprb),
           "psi": psi, "prb": prb_out, "seconds": seconds,
           "counts": {fn.__name__: fn.launches for fn in counters},
           "plain": sum(fn.launches for fn in plain),
           "collectives": cg.all_reduce.launches,
           "collective_bytes": cg.all_reduce.bytes,
           "sizes": dict(cg.all_reduce.sizes)}
    if what == "run":
        out["metrics"] = {k: v for k, v in m.items() if k != "cg_state"}
        out["busy"] = device_busy(torch, lambda: run_sharded(
            data, psi0, scan, prb, g, mesh,
            **dict(kw, piter=PROFILE_ITERS)))
    else:
        out["stages"] = [(name, int(mm["iters_run"]), mm["evaluations"],
                          float(mm["residual"][max(int(mm["iters_run"])
                                                   - 1, 0)]))
                         for name, mm in stages]
    del data, scan, psi0
    torch.cuda.empty_cache()
    return out


def tiled_job(rank, world, mesh_shape, geom, seed, kw, perturb=0.0):
    """A rank of phase 18 (a RankPool job; the ranks import this script as
    their main module, never jax). Builds the problem from ``seed``, checks
    with an all-reduced checksum that every rank built the same one, warms
    up, then runs ``run_tiled(**kw)`` on the tiling mesh of ``mesh_shape``
    between two synchronises, with every launch count, the all-reduces and
    the halo broadcasts counted from zero. Also returns this rank's real
    and padded positions."""
    import torch
    import torch.distributed as dist

    from tikejax_torch import Geometry
    from tikejax_torch.parallel import _jobs, run_tiled, tiling
    from tikejax_torch.solvers import cg

    dev = torch.device("cuda", torch.cuda.current_device())
    g = Geometry(**geom)
    data, psi0, scan, prb = sharded_problem(torch, g, seed, dev, perturb)
    mine, same = rank_checksum(torch, data, scan, prb)
    mesh = _jobs.tiling_mesh(mesh_shape, device_type="cuda")
    counters, plain = kernel_counters()
    run_tiled(data, psi0, scan, prb, g, mesh, **dict(kw, piter=2))
    for fn in counters + plain + [cg.all_reduce, cg.halo_exchange]:
        fn.launches = 0
    for fn in (cg.all_reduce, cg.halo_exchange):
        fn.bytes, fn.sizes = 0, {}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    psi, prb_out, m = run_tiled(data, psi0, scan, prb, g, mesh, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # This rank's share of its slab's padded list of positions.
    _, _, tsh, dsh, ssh, ti, di, si = tiling._layout(mesh)
    _, owner, s_loc = tiling._owners(scan, g, dsh, ssh)
    per, t_local = s_loc // ssh, g.ntheta // tsh
    real = sum(min(max(int((owner[t] == di).sum()) - si * per, 0), per)
               for t in range(ti * t_local, (ti + 1) * t_local))
    out = {"same_problem": same, "checksum": mine, "psi": psi,
           "prb": prb_out, "seconds": seconds,
           "metrics": {k: v for k, v in m.items() if k != "cg_state"},
           "counts": {fn.__name__: fn.launches for fn in counters},
           "plain": sum(fn.launches for fn in plain),
           "collectives": cg.all_reduce.launches,
           "collective_bytes": cg.all_reduce.bytes,
           "sizes": dict(cg.all_reduce.sizes),
           "halo": cg.halo_exchange.launches,
           "halo_bytes": cg.halo_exchange.bytes,
           "positions": (real, per * t_local),
           "local": (t_local, per, g.nmodes, g.nprb)}
    del data, scan, psi0
    torch.cuda.empty_cache()
    return out


def scatter_skip_turns(torch, timer, kernels, label, frames, scan_i, prb,
                       nz, n):
    """scatter_conj_probe's tile kernel with the chunk skip against the
    forced walk over every chunk: the same bits, then (skip ms, no-skip
    ms) in turns."""
    got = kernels.scatter_conj_probe(frames, scan_i, prb, nz, n)
    check(torch.equal(got, kernels._scatter_conj_probe_cuda(
        frames, scan_i, prb, nz, n, skip=False)),
          (label, "the chunk skip changed the bits"))
    del got
    return in_turns_ms(
        torch, timer, f"scatter skip {label}",
        lambda: kernels.scatter_conj_probe(frames, scan_i, prb, nz, n),
        lambda: kernels._scatter_conj_probe_cuda(frames, scan_i, prb, nz, n,
                                                 skip=False))


def large_kernels(torch, fused, kernels, g, psi, data, scan_i, prb, card,
                  gen):
    """Phase 19's kernels at a large shape, outside the counted runs:
    grad_fused (in scan order), minf_fused, fwd, adj and adj_probe
    against their plain versions over chunks of positions
    (:func:`compare_at_scale`, with and without a base); the tile scatter
    against its plain version, bitwise across launches, with and without
    the chunk skip, and grad_fused's gradient the same bits at 512 and 32
    MiB of frame scratch; each timed (median of 10) beside its bound, and
    the tile kernel's walk alone (every position masked, every chunk
    walked). Returns {kernel: (abs err, ms, bound)} and the scatter's
    extra times."""
    psi_r = psi + 0.05 * torch.randn(psi.shape, dtype=psi.dtype,
                                     device=psi.device, generator=gen)
    base = fused.fwd(0.5 * psi_r, scan_i, prb, g.ndet, split_out=True)
    errs = compare_at_scale(torch, fused, g, psi_r, data, scan_i, prb, base,
                            LARGE_CHUNK)
    frames = fused._base_complex(base)
    parts = [slice(i, min(i + LARGE_CHUNK, g.nscan))
             for i in range(0, g.nscan, LARGE_CHUNK)]
    s_k = kernels.scatter_conj_probe(frames, scan_i, prb, g.nz, g.n)
    check(kernels.scatter_conj_probe.variant == "tile" and torch.equal(
        s_k, kernels.scatter_conj_probe(frames, scan_i, prb, g.nz, g.n))
        and torch.equal(s_k, kernels._scatter_conj_probe_cuda(
            frames, scan_i, prb, g.nz, g.n, skip=False)),
          (str(g), "the tile scatter is not the same bits"))
    s_r = sum(kernels.scatter_conj_probe_reference(
        frames[:, c], scan_i[:, c], prb, g.nz, g.n) for c in parts)
    errs["scatter_conj_probe"] = rel_err(torch, s_k, s_r)
    check(bool(torch.isfinite(s_k).all())
          and errs["scatter_conj_probe"][0] <= GRAD_TOL,
          (str(g), "scatter_conj_probe", errs["scatter_conj_probe"]))
    del s_k, s_r
    grads = []
    for mib in LARGE_BUDGETS:
        chunk = mib * 2**20 // (g.nmodes * g.nprb**2 * 8)
        grads.append(fused._grad_fused_cuda(psi_r, data, scan_i, prb, g.ndet,
                                            "gaussian", None, chunk=chunk))
    check(all(torch.equal(x[0], grads[0][0])
              and float(x[1]) == float(grads[0][1]) for x in grads),
          (str(g), "grad_fused: not the same bits at every frame scratch"))
    del grads
    masked = scan_i.clone()
    masked[..., 0] = -1
    px = psi_r.numel() * 8
    times = {
        "grad_fused": (lambda: fused.grad_fused(
            psi_r, data, scan_i, prb, g.ndet, "gaussian"),
            bound(fft_flops(scan_i, g.nmodes, g.ndet, 2),
                  nbytes(psi_r, prb, data, scan_i) + px + 4)),
        "minf_fused": (lambda: fused.minf_fused(
            psi_r, data, scan_i, prb, g.ndet, "gaussian"),
            bound(fft_flops(scan_i, g.nmodes, g.ndet, 1),
                  nbytes(psi_r, prb, data, scan_i) + 4)),
        "fwd": (lambda: fused.fwd(psi_r, scan_i, prb, g.ndet),
                bound(fft_flops(scan_i, g.nmodes, g.ndet, 1),
                      nbytes(psi_r, prb, scan_i, frames))),
        "scatter_conj_probe": (lambda: kernels.scatter_conj_probe(
            frames, scan_i, prb, g.nz, g.n),
            bound(8 * frames.numel(), nbytes(frames, prb, scan_i) + px)),
    }
    out = {}
    for name, (fn, bnd) in times.items():
        fn()
        out[name] = (errs[name][1], median_ms(torch, fn, 10), bnd)
    noskip = median_ms(torch, lambda: kernels._scatter_conj_probe_cuda(
        frames, scan_i, prb, g.nz, g.n, skip=False), 10)
    walk = median_ms(torch, lambda: kernels._scatter_conj_probe_cuda(
        frames, masked, prb, g.nz, g.n, skip=False), 10)
    tiles_y, tiles_x, _ = kernels.scatter_tile_plan(g.ntheta, g.nz, g.n)
    log("large", f"{g} kernels against their plain versions (over chunks "
        f"of {LARGE_CHUNK} positions; grad_fused, minf_fused, fwd with and "
        "without a split-view base, adj and adj_probe on it): " + ", ".join(
            f"{k} err {e:.2e}" for k, (e, _) in errs.items())
        + "; the tile scatter bitwise repeatable and the same bits with "
        "and without the chunk skip, grad_fused the same bits at "
        f"{' and '.join(str(b) for b in LARGE_BUDGETS)} MiB of frame "
        "scratch; median of 10: " + ", ".join(
            f"{k} {ms:.3f} ms (bound {b[0]:.3f} by {b[1]})"
            for k, (_, ms, b) in out.items())
        + f"; the tile scatter without the skip {noskip:.3f} ms, its walk "
        f"alone (every position masked, every chunk walked) {walk:.3f} ms: "
        f"{100 * walk / noskip:.1f}% of it ({tiles_y * tiles_x} tiles x "
        f"{g.nscan} positions); on {card}")
    return out, {"noskip_ms": noskip, "walk_ms": walk}


def large_phase(torch, dev, card, timer, reset_counts, counters, plain):
    """Phase 19 (see the module note): returns ({run label: (launches,
    the shape of one call)}, {configuration: kernel times}, the tile
    scatter in turns with and without the chunk skip)."""
    from tikejax_torch import Geometry
    from tikejax_torch.models import make_problem
    from tikejax_torch.models.simulate import make_probe, raster_scan
    from tikejax_torch.ops import fused, kernels
    from tikejax_torch.ops.patches import scan_to_int
    from tikejax_torch.solvers import reconstruct, run

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    # The tile scatter in turns with and without the skip at the headline
    # frame size (random frames; no data needed).
    gh = Geometry(**HEADLINE)
    scan_h = scan_to_int(raster_scan(gen, gh, device=dev))
    prb_h = make_probe(1, 1, gh.nprb, device=dev)
    frames_h = torch.randn(gh.farplane_shape, dtype=torch.complex64,
                           device=dev, generator=gen)
    turns = {"headline": scatter_skip_turns(torch, timer, kernels, "headline",
                                            frames_h, scan_h, prb_h, gh.nz,
                                            gh.n)}
    del frames_h
    counts, kernel_times = {}, {}
    for label, geom in LARGE.items():
        g = Geometry(**geom)
        t0 = time.perf_counter()
        _, scan, prb, data = make_problem(gen, g, device=dev)
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        psi0 = torch.ones(g.psi_shape, dtype=torch.complex64, device=dev)
        scan_i = scan_to_int(scan)
        if label != "1024":
            kernel_times[label] = large_kernels(
                torch, fused, kernels, g, psi0, data, scan_i, prb, card, gen)
            if label == "2048":
                turns[label] = scatter_skip_turns(
                    torch, timer, kernels, label, torch.randn(
                        g.farplane_shape, dtype=torch.complex64, device=dev,
                        generator=gen), scan_i, prb, g.nz, g.n)
            torch.cuda.empty_cache()
        run(data, psi0, scan, prb, g, piter=3)  # warm-up
        held = reset_counts()
        t0 = time.perf_counter()
        psi, _, m = run(data, psi0, scan, prb, g, piter=LARGE_ITERS[label],
                        model="gaussian")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - held
        counts[f"large {label}"] = ({fn.__name__: fn.launches
                                     for fn in counters}, shape(g))
        check(all(fn.launches == 0 for fn in plain), "plain version ran")
        chunks = frame_launches(fused, *shape(g))
        check(fused.grad_fused.launches == m["evaluations"] * chunks > 0
              and kernels.scatter_conj_probe.launches
              == fused.grad_fused.launches,
              (label, fused.grad_fused.launches, m["evaluations"], chunks))
        iters = int(m["iters_run"])
        res = m["residual"][:iters].cpu()
        limit = fused.FRAME_SCRATCH_BYTES + LARGE_OBJECTS * psi0.numel() * 8
        check(psi.shape == g.psi_shape and bool(torch.isfinite(psi).all()),
              (label, "psi shape or finiteness"))
        check(float(res[-1]) <= 0.1 * float(res[0]), (label, res))
        check(peak <= limit, (label, f"peak extra memory {peak} bytes"))
        log("large", f"{label}: {g} gaussian, solver defaults, made in "
            f"{made_s:.1f} s; {iters} iters in {seconds:.3f} s: "
            f"{iters / seconds:.2f} iters/s, {1e3 * seconds / iters:.2f} "
            f"ms/iter, {m['evaluations'] / iters:.2f} evals/iter, "
            f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
            f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, peak extra "
            f"memory {peak / 2**20:.1f} MiB (limit {limit / 2**20:.1f}: the "
            f"frame scratch and {LARGE_OBJECTS} objects), grad_fused and "
            f"the tile scatter {fused.grad_fused.launches} launches each "
            f"({chunks} chunks of frames an evaluation), on {card}")
        del psi, m
        if label == "1024":
            held = reset_counts()
            t0 = time.perf_counter()
            psi, _, stages = reconstruct(data, psi0, scan, prb, g,
                                         target_residual=LARGE_TARGET,
                                         max_segments=LARGE_MAX_SEGMENTS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) - held
            counts["large 1024 deep"] = ({fn.__name__: fn.launches
                                          for fn in counters}, shape(g))
            check(all(fn.launches == 0 for fn in plain), "plain version ran")
            iters = [int(mm["iters_run"]) for _, mm in stages]
            evals = sum(mm["evaluations"] for _, mm in stages)
            n_split = sum(1 for name, _ in stages if name.startswith("split:"))
            res_end = final_residual(stages)
            check(bool(torch.isfinite(psi).all()), "psi finiteness")
            check(res_end <= LARGE_TARGET, (label, "deep", res_end,
                                            len(stages)))
            check(fused.grad_fused.launches == evals * chunks > 0,
                  (label, "deep", fused.grad_fused.launches, evals))
            log("large", f"{label}: {g} reconstruct(target_residual="
                f"{LARGE_TARGET:g}) defaults from psi0 = ones: "
                f"{seconds:.3f} s, {sum(iters)} iters in {len(stages)} "
                f"stages ({n_split} refinement segments) "
                f"{[f'{n}:{k}' for (n, _), k in zip(stages, iters)]}, final "
                f"residual {res_end:.4e}, {evals / sum(iters):.3f} "
                f"evals/iter, peak extra memory {peak / 2**30:.3f} GiB, "
                f"launches {counts['large 1024 deep'][0]}, on {card}")
            del psi, stages
        del data, scan, prb, psi0, scan_i
        torch.cuda.empty_cache()
    log("large", "the tile scatter with the chunk skip / every chunk walked, "
        "5 back-to-back launches each in turns walked, skip, skip, walked: "
        + "; ".join(f"{k} {new:.3f} / {old:.3f} ms ({old / new:.2f}x)"
                    for k, (new, old) in turns.items())
        + f"; the same bits; on {card}")
    return counts, kernel_times, turns


def final_residual(stages) -> float:
    m = stages[-1][1]
    return float(m["residual"][max(int(m["iters_run"]) - 1, 0)])


def main() -> None:
    if not all((ROOT / src).is_file() for src, _ in KERNEL_SOURCES.values()):
        raise SystemExit("chip_smoke.py: tikejax_torch/ is not beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from tikejax_torch import Geometry
    from tikejax_torch.models import likelihoods, make_problem
    from tikejax_torch import compat, native
    from tikejax_torch.ops import _launch, diffraction, fused, kernels
    from tikejax_torch.ops import linesearch
    from tikejax_torch.ops.patches import scan_to_int
    from tikejax_torch.solvers import cg, reconstruct, run
    from tikejax_torch.utils import Timer, cuda_build

    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    # Plain fp32 everywhere: the reference must not run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible; "
        f"SM clock at most {sm_mhz:g} MHz")
    dev = torch.device("cuda", 0)

    # -- 2. build --------------------------------------------------------
    timer = Timer()
    log("build", f"build directory {cuda_build.BUILD_DIR} (the checkout's "
        "build/kernels where it can be written, else the user's cache)")
    with timer("build"):
        built = cuda_build.build_all(tuple(KERNEL_SOURCES))
    for name, (path, seconds, report) in built.items():
        regs = cuda_build.kernel_reports(report).values()
        spills = sum(v["spill_stores"] + v["spill_loads"] for v in regs)
        log("build", f"{path.relative_to(ROOT)} in {seconds:.1f} s; "
            f"{len(regs)} kernels, registers "
            f"{sorted({v['registers'] for v in regs})}, spill bytes {spills}")
    log("build", f"{len(built)} libraries in {timer.times['build']:.1f} s "
        "wall (parallel nvcc)")
    fft_regs = {name: kernel_report(cuda_build, built[name][2], entry)
                for name, (entry, _) in HEADLINE_ENTRIES.items()}
    gemm_regs = {name: kernel_report(cuda_build, built[name][2], entry)
                 for name, (_, entry) in HEADLINE_ENTRIES.items()}

    # -- 3. kernels vs plain versions --------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # The bases and perturbations of this phase come from their own
    # stream, so that the problems of the later phases stay the same.
    gen2 = torch.Generator(device=dev).manual_seed(SEED + 1)
    # The directions of the materialized kernels' checks, likewise.
    gen4 = torch.Generator(device=dev).manual_seed(SEED + 3)
    # The gather's awkward cases, likewise.
    gen5 = torch.Generator(device=dev).manual_seed(SEED + 4)

    def crandn(*shape, generator=gen):
        return torch.complex(
            torch.randn(shape, generator=generator, device=dev),
            torch.randn(shape, generator=generator, device=dev))

    small = Geometry(nz=97, n=101, nscan=37, ndet=72, nprb=56, ntheta=2,
                     nmodes=2)
    _, scan_s, prb_s, data_s = make_problem(gen, small, device=dev)
    scan_si = scan_to_int(scan_s)
    scan_si[1, 5, 0] = -1  # one masked dummy position
    psi_s = crandn(*small.psi_shape)
    base_s = crandn(*small.farplane_shape, generator=gen2)
    args_s = (psi_s, data_s, scan_si, prb_s)
    for model in ("gaussian", "poisson"):
        errs = [compare_grad(torch, fused, args_s, small.ndet, model, b)[:2]
                for b in (None, base_s)]
        m_errs = [compare_minf(torch, fused, args_s, small.ndet, model, b)[0]
                  for b in (None, base_s)]
        log("kernel", f"small {small} {model}: grad_fused grad/minf err "
            f"{errs[0][0]:.2e}/{errs[0][1]:.2e}, with base "
            f"{errs[1][0]:.2e}/{errs[1][1]:.2e}; minf_fused err "
            f"{m_errs[0]:.2e}, with base {m_errs[1]:.2e}")
    f_errs = [compare_fwd(torch, fused, psi_s, scan_si, prb_s, small.ndet,
                          b)[0] for b in (None, base_s)]
    log("kernel", f"small {small}: fwd err {f_errs[0]:.2e}, with base "
        f"{f_errs[1]:.2e} (split views identical)")
    for model in ("gaussian", "poisson"):
        gp_err, fp_err, _ = compare_grad_prb(torch, fused, args_s, small.ndet,
                                             model)
        log("kernel", f"small {small} {model}: grad_prb_fused grad/minf err "
            f"{gp_err:.2e}/{fp_err:.2e} (bitwise repeatable)")
    (a_err, _), (p_err, _) = compare_adjoints(torch, fused, base_s, scan_si,
                                              prb_s, psi_s)
    log("kernel", f"small {small}: adj err {a_err:.2e}, adj_probe err "
        f"{p_err:.2e} (bitwise repeatable)")
    ran = [fn.variant for fn in (fused.grad_fused, fused.minf_fused,
                                 fused.grad_prb_fused, fused.fwd, fused.adj,
                                 fused.adj_probe)]
    check(ran == ["gemm"] * 6 and fused.dft_variant(
        small.nprb, small.ndet, small.nmodes) == "gemm", ran)
    log("kernel", f"small {small}: grad_fused, minf_fused, grad_prb_fused, "
        "fwd, adj and adj_probe ran their 'gemm' variant (72 is no power of "
        "two)")
    # The FFT variants on a power-of-two awkward case.
    pow2 = Geometry(**POW2_SMALL)
    _, scan_p, prb_p, data_p = make_problem(gen2, pow2, device=dev)
    scan_pi = scan_to_int(scan_p)
    scan_pi[1, 5, 0] = -1
    args_p = (crandn(*pow2.psi_shape, generator=gen2), data_p, scan_pi, prb_p)
    base_p = crandn(*pow2.farplane_shape, generator=gen2)
    check(fused.dft_variant(pow2.nprb, pow2.ndet, pow2.nmodes) == "fft",
          "the power-of-two case should take the FFT variant")
    for model in ("gaussian", "poisson"):
        for v in ("fft", "gemm"):
            for b in (None, base_p):
                errs = compare_variant(torch, fused, args_p, pow2.ndet, model,
                                       b, base_p, v)
                log("kernel", f"small {pow2} {model} '{v}' variant"
                    f"{' with base' if b is not None else ''}, value/"
                    f"objective err: {show_errs(errs)}")
    log("kernel", f"small {pow2}: on both variants every objective, both "
        "probe sums, fwd's farplane, fwd_quad_stats' planes and the object "
        "scatters of adj, grad_fused and adj_residual bitwise repeatable; "
        "on 'fft' the objectives of grad_fused, "
        "minf_fused and grad_prb_fused equal bit for bit, minf_fused of "
        "zeros on fwd's farplane equal to minf_fused's objective bit for "
        "bit, and fwd_quad_stats of psi on fwd(psi) a == b == c bit for bit")
    del args_p, base_p, data_p
    far_s = fused.fwd(psi_s, scan_si, prb_s, small.ndet)
    dpsi_s = 0.1 * crandn(*small.psi_shape, generator=gen4)
    dprb_s = 0.1 * crandn(*small.prb_shape, generator=gen4)
    fd_s = fused.fwd(dpsi_s, scan_si, prb_s, small.ndet)
    for model in ("gaussian", "poisson"):
        ar_err, arf_err, _ = compare_adj_residual(
            torch, fused, far_s, data_s, scan_si, prb_s, small.nz, small.n,
            model)
        ls_err, _ = compare_ls(torch, linesearch, far_s, fd_s, data_s,
                               model)
        check(fused.adj_residual.variant == "gemm",
              fused.adj_residual.variant)
        log("kernel", f"small {small} {model}: adj_residual ('gemm' variant) "
            f"grad/minf err {ar_err:.2e}/{arf_err:.2e}; ls_objectives err "
            f"{ls_err:.2e} at {len(LS_STEPS)} steps (bitwise repeatable)")
    q_errs = [compare_quad_stats(torch, fused, x, scan_si, p, far_s)[0]
              for x, p in ((dpsi_s, prb_s), (psi_s, dprb_s))]
    check(fused.fwd_quad_stats.variant == "gemm",
          fused.fwd_quad_stats.variant)
    log("kernel", f"small {small}: fwd_quad_stats ('gemm' variant) err "
        f"{q_errs[0]:.2e} (object direction), {q_errs[1]:.2e} (probe "
        "direction), bitwise repeatable")
    del far_s, fd_s
    # The adjoints' frames as the operators hand them over: the 56^2 crop
    # of 72^2 frames, a strided view.
    near_s = base_s[..., :small.nprb, :small.nprb]
    check(not near_s.is_contiguous(), "the small crop should be strided")
    # The same arrays on the host, for the facade's operators (phase 15).
    small_np = tuple(x.cpu().numpy() for x in (psi_s, base_s, prb_s, scan_s))
    h_errs = compare_hybrid(torch, kernels, psi_s, scan_si, prb_s, near_s)
    log("kernel", f"small {small}: " + ", ".join(
        f"{k} err {e:.2e}" for k, (e, _) in h_errs.items())
        + " (adjoints on the strided crop; all three bitwise "
        "repeatable)")
    # gather_probe_mul's kernel on awkward cases: odd and even object
    # rows (16-byte object loads only in the second), even and odd nprb
    # (pixel pairs or pixels), 2 angles x 2 modes, a masked position.
    psi_e = crandn(small.ntheta, small.nz, small.n + 1, generator=gen5)
    prb_odd = crandn(small.ntheta, small.nmodes, small.nprb - 1,
                     small.nprb - 1, generator=gen5)
    gather_cases = [(psi_s, prb_s), (psi_e, prb_s), (psi_s, prb_odd),
                    (psi_e, prb_odd), (psi_s, prb_p)]
    masked = [gather_repeatable(torch, kernels, x, scan_si, p)
              for x, p in gather_cases[:4]]
    masked.append(gather_repeatable(torch, kernels, gather_cases[4][0],
                                    scan_pi, prb_p))
    odd_err = rel_err(torch, kernels.gather_probe_mul(psi_e, scan_si,
                                                      prb_odd),
                      kernels.gather_probe_mul_reference(psi_e, scan_si,
                                                         prb_odd))[0]
    check(odd_err <= GRAD_TOL, ("gather_probe_mul, odd nprb", odd_err))
    log("kernel", "gather_probe_mul: the persistent kernel within "
        f"{GRAD_TOL:g} of its plain version, bitwise repeatable, masked "
        "frames zero (" + ", ".join(f"n {x.shape[-1]} nprb {p.shape[-1]}"
                        for x, p in gather_cases)
        + f"; 2 angles x 2 modes; {masked} positions masked); odd nprb "
        f"against the plain version {odd_err:.2e}")
    del psi_e, prb_odd, gather_cases
    # scatter_conj_probe's tile kernel on awkward cases: odd and even n
    # (partial edge tiles), nprb 56, 55 and 48, strided crops (ndet > nprb)
    # and contiguous frames, 2 angles x 2 modes, a masked position and
    # windows on the object's last row and column.
    scatter_errs = {}
    for n_e, p_e, d_e in ((small.n, 56, 72), (small.n + 1, 55, 64),
                          (small.n, 48, 48), (small.n + 1, 48, 64)):
        frames_e = crandn(small.ntheta, small.nscan, small.nmodes, d_e, d_e,
                          generator=gen5)[..., :p_e, :p_e]
        prb_e = crandn(small.ntheta, small.nmodes, p_e, p_e, generator=gen5)
        scan_e = scan_si.clone()
        for at, corner in (((0, 0), (small.nz - p_e, n_e - p_e)),
                           ((0, 1), (0, n_e - p_e)),
                           ((1, 0), (small.nz - p_e, 0))):
            scan_e[at] = torch.tensor(corner, dtype=torch.int32)
        check(frames_e.is_contiguous() == (d_e == p_e), (d_e, p_e))
        scatter_errs[n_e, p_e, d_e] = scatter_as_tile(
            torch, kernels, frames_e, scan_e, prb_e, small.nz, n_e)
    del frames_e, prb_e, scan_e
    log("kernel", "scatter_conj_probe: the tile kernel bitwise repeatable, "
        "every position masked exactly zero; err against the plain version "
        "/ the forced atomic kernel (" + ", ".join(
            f"n {n_e} nprb {p_e} ndet {d_e} {e:.2e}/{a:.2e}"
            for (n_e, p_e, d_e), (e, a) in scatter_errs.items())
        + "; 2 angles x 2 modes, one position masked, windows on the last "
        "row and column)")

    g = Geometry(**HEADLINE)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64, device=dev)
    scan_i = scan_to_int(scan)
    psi_r = psi0 + 0.05 * crandn(*g.psi_shape, generator=gen2)
    args = (psi_r, data, scan_i, prb)
    base = fused.fwd(0.5 * psi_r, scan_i, prb, g.ndet)
    results = {}
    g_err, f_err, abs_err = compare_grad(torch, fused, args, g.ndet,
                                         "gaussian")
    gb_err, fb_err, _ = compare_grad(torch, fused, args, g.ndet, "gaussian",
                                     base)
    ms = median_ms(torch, lambda: fused.grad_fused(*args, g.ndet,
                                                   "gaussian"), 10)
    base_ms = median_ms(torch, lambda: fused.grad_fused(
        *args, g.ndet, "gaussian", base=base), 10)
    plain_ms = median_ms(torch, lambda: fused.grad_fused_reference(
        *args, g.ndet, "gaussian"), 10)
    results["grad_fused"] = (abs_err, ms, plain_ms)
    bounds = {"grad_fused": bound(fft_flops(scan_i, g.nmodes, g.ndet, 2),
                                  nbytes(psi_r, prb, data, scan_i, psi_r)
                                  + 4)}
    check(fused.grad_fused.variant == "fft", fused.grad_fused.variant)
    log("kernel", f"headline {g} grad_fused ('fft' variant): grad/minf err "
        f"{g_err:.2e}/{f_err:.2e}, with base {gb_err:.2e}/{fb_err:.2e}; "
        f"kernel {ms:.3f} ms, with base {base_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, median of 10 on {card}")

    fw_err, fw_abs = compare_fwd(torch, fused, psi_r, scan_i, prb, g.ndet)
    fwb_err, _ = compare_fwd(torch, fused, psi_r, scan_i, prb, g.ndet, base)
    check(fused.fwd.variant == "fft", fused.fwd.variant)
    ms = median_ms(torch, lambda: fused.fwd(psi_r, scan_i, prb, g.ndet), 10)
    base_ms = median_ms(torch, lambda: fused.fwd(psi_r, scan_i, prb, g.ndet,
                                                 base=base), 10)
    plain_ms = median_ms(torch, lambda: fused.fwd_reference(
        psi_r, scan_i, prb, g.ndet), 10)
    results["fwd"] = (fw_abs, ms, plain_ms)
    bounds["fwd"] = bound(fft_flops(scan_i, g.nmodes, g.ndet, 1),
                          nbytes(psi_r, prb, scan_i, base))
    check(ms < plain_ms, ("fwd is not faster than its plain version", ms,
                          plain_ms))
    # fwd's farplane is the one minf_fused forms inside (`base` is
    # fwd(0.5 psi_r)); compare_variant below holds it on a base too.
    via = fwd_feeds_minf(torch, fused, 0.5 * psi_r, data, scan_i, prb,
                         g.ndet, base)
    log("kernel", f"headline {g} fwd ('fft' variant): err {fw_err:.2e}, "
        f"with base {fwb_err:.2e}; kernel {ms:.3f} ms, with base "
        f"{base_ms:.3f} ms, plain {plain_ms:.3f} ms, median of 10 on "
        f"{card}; minf_fused of zeros on fwd's farplane equal bit for bit "
        f"to minf_fused's objective ({via:.9e})")

    m_err, m_abs = compare_minf(torch, fused, args, g.ndet, "gaussian")
    mb_err, _ = compare_minf(torch, fused, args, g.ndet, "gaussian", base)
    ms = median_ms(torch, lambda: fused.minf_fused(*args, g.ndet,
                                                   "gaussian"), 10)
    base_ms = median_ms(torch, lambda: fused.minf_fused(
        *args, g.ndet, "gaussian", base=base), 10)
    plain_ms = median_ms(torch, lambda: fused.minf_fused_reference(
        *args, g.ndet, "gaussian"), 10)
    results["minf_fused"] = (m_abs, ms, plain_ms)
    bounds["minf_fused"] = bound(fft_flops(scan_i, g.nmodes, g.ndet, 1),
                                 nbytes(psi_r, prb, data, scan_i) + 4)
    check(fused.minf_fused.variant == "fft", fused.minf_fused.variant)
    log("kernel", f"headline {g} minf_fused ('fft' variant): err "
        f"{m_err:.2e}, with base {mb_err:.2e}; kernel {ms:.3f} ms, with base {base_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, median of 10 on {card}")

    gp_err, fp_err, gp_abs = compare_grad_prb(torch, fused, args, g.ndet,
                                              "gaussian")
    ms = median_ms(torch, lambda: fused.grad_prb_fused(*args, g.ndet,
                                                       "gaussian"), 10)
    plain_ms = median_ms(torch, lambda: fused.grad_prb_fused_reference(
        *args, g.ndet, "gaussian"), 10)
    results["grad_prb_fused"] = (gp_abs, ms, plain_ms)
    bounds["grad_prb_fused"] = bound(
        fft_flops(scan_i, g.nmodes, g.ndet, 2),
        nbytes(psi_r, prb, data, scan_i, prb) + 4)
    check(fused.grad_prb_fused.variant == "fft", fused.grad_prb_fused.variant)
    log("kernel", f"headline {g} grad_prb_fused ('fft' variant): grad/minf "
        f"err {gp_err:.2e}/{fp_err:.2e} (bitwise repeatable); kernel "
        f"{ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bounds['grad_prb_fused'][0]:.3f} ms, "
        f"median of 10 on {card}")
    (a_err, a_abs), (p_err, p_abs) = compare_adjoints(torch, fused, base,
                                                      scan_i, prb, psi_r)
    for name, fn, plain_fn, other, err, abs_e in (
            ("adj", lambda: fused.adj(base, scan_i, prb, g.nz, g.n),
             lambda: fused.adj_reference(base, scan_i, prb, g.nz, g.n),
             psi_r, a_err, a_abs),
            ("adj_probe", lambda: fused.adj_probe(base, scan_i, psi_r, g.nprb),
             lambda: fused.adj_probe_reference(base, scan_i, psi_r, g.nprb),
             prb, p_err, p_abs)):
        ms = median_ms(torch, fn, 10)
        plain_ms = median_ms(torch, plain_fn, 10)
        results[name] = (abs_e, ms, plain_ms)
        moved = nbytes(base, scan_i, prb if name == "adj" else psi_r, other)
        bounds[name] = bound(fft_flops(scan_i, g.nmodes, g.ndet, 1), moved)
        log("kernel", f"headline {g} {name} ('fft' variant): err "
            f"{err:.2e}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bounds[name][0]:.3f} ms, median of "
            f"10 on {card}")
    check(fused.adj.variant == fused.adj_probe.variant == "fft",
          (fused.adj.variant, fused.adj_probe.variant))
    # The materialized mode's kernels on G psi_r and a direction.
    far = fused.fwd(psi_r, scan_i, prb, g.ndet)
    # fwd and adj are a pair through the same transform: <G psi_r, base>
    # against <psi_r, G^H base>, in complex128.

    def vdot(a, b):
        return complex(torch.vdot(a.reshape(-1).to(torch.complex128),
                                  b.reshape(-1).to(torch.complex128)))

    lhs = vdot(far, base)
    pair_err = abs(lhs - vdot(psi_r, fused.adj(base, scan_i, prb, g.nz,
                                                g.n))) / abs(lhs)
    check(fused.fwd.variant == fused.adj.variant == "fft"
          and pair_err <= PAIR_TOL, ("fwd/adj pair", pair_err))
    log("kernel", f"headline {g}: <fwd(psi), f> = <psi, adj(f)> to "
        f"{pair_err:.2e} on 'fft' (limit {PAIR_TOL:g})")
    dpsi_h = 0.05 * crandn(*g.psi_shape, generator=gen4)
    ar_err, arf_err, ar_abs = compare_adj_residual(
        torch, fused, far, data, scan_i, prb, g.nz, g.n, "gaussian")
    check(fused.adj_residual.variant == "fft", fused.adj_residual.variant)
    ms = median_ms(torch, lambda: fused.adj_residual(
        far, data, scan_i, prb, g.nz, g.n, "gaussian"), 10)
    plain_ms = median_ms(torch, lambda: fused.adj_residual_reference(
        far, data, scan_i, prb, g.nz, g.n, "gaussian"), 10)
    results["adj_residual"] = (ar_abs, ms, plain_ms)
    bounds["adj_residual"] = bound(fft_flops(scan_i, g.nmodes, g.ndet, 1),
                                   nbytes(far, data, scan_i, prb, psi_r) + 4)
    log("kernel", f"headline {g} adj_residual ('fft' variant): grad/minf "
        f"err {ar_err:.2e}/{arf_err:.2e} (objective bitwise repeatable); "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bounds['adj_residual'][0]:.3f} ms, median of 10 on {card}")
    q_err, q_abs = compare_quad_stats(torch, fused, dpsi_h, scan_i, prb, far)
    check(fused.fwd_quad_stats.variant == "fft", fused.fwd_quad_stats.variant)
    ms = median_ms(torch, lambda: fused.fwd_quad_stats(dpsi_h, scan_i, prb,
                                                       far), 10)
    plain_ms = median_ms(torch, lambda: fused.fwd_quad_stats_reference(
        dpsi_h, scan_i, prb, far), 10)
    results["fwd_quad_stats"] = (q_abs, ms, plain_ms)
    bounds["fwd_quad_stats"] = bound(
        fft_flops(scan_i, g.nmodes, g.ndet, 1),
        nbytes(dpsi_h, scan_i, prb, far) + 3 * nbytes(data))
    # The direction's farplane is fwd's, bit for bit: the statistics of
    # psi_r on far = fwd(psi_r) are three equal planes.
    equal_stats(torch, fused.fwd_quad_stats(psi_r, scan_i, prb, far), scan_i)
    log("kernel", f"headline {g} fwd_quad_stats ('fft' variant): err "
        f"{q_err:.2e} (bitwise repeatable; of psi on fwd(psi) a == b == c "
        f"bit for bit); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bounds['fwd_quad_stats'][0]:.3f} ms, median of 10 on {card}")
    # Both variants of the redesigned kernels at the headline: the
    # 'gemm' variant, forced, still agrees with the plain version; then
    # the times, taken in turns within this run.
    for v in ("gemm", "fft"):
        errs = compare_variant(torch, fused, args, g.ndet, "gaussian", None,
                               base, v)
        log("kernel", f"headline {g} forced '{v}' variant, value/objective "
            f"err: {show_errs(errs)} (objectives, probe sums, fwd's "
            "farplane and the object scatters of adj, grad_fused and "
            "adj_residual bitwise repeatable)")
    dev_i = dev.index
    variant_lines = {}
    for name, run_variant in (
            ("grad_fused", lambda **kw: fused._grad_fused_cuda(
                *args, g.ndet, "gaussian", None, **kw)),
            ("minf_fused", lambda **kw: fused._minf_fused_cuda(
                *args, g.ndet, "gaussian", None, **kw)),
            ("grad_prb_fused", lambda **kw: fused._grad_prb_fused_cuda(
                *args, g.ndet, "gaussian", **kw)),
            ("fwd", lambda **kw: fused._fwd_cuda(
                psi_r, scan_i, prb, g.ndet, None, **kw)),
            ("adj", lambda **kw: fused._adj_cuda(
                base, scan_i, prb, g.nz, g.n, **kw)),
            ("adj_probe", lambda **kw: fused._adj_probe_cuda(
                base, scan_i, psi_r, g.nprb, **kw)),
            ("adj_residual", lambda **kw: fused._adj_residual_cuda(
                far, data, scan_i, prb, g.nz, g.n, "gaussian", **kw)),
            ("fwd_quad_stats", lambda **kw: fused._fwd_quad_stats_cuda(
                dpsi_h, scan_i, prb, far, **kw))):
        fft_ms, gemm_ms = in_turns_ms(
            torch, timer, name, lambda: run_variant(variant="fft"),
            lambda: run_variant(variant="gemm"))
        # The data prefetch's plane (one mode, aligned data), of the three
        # kernels that have one.
        planes = int(name in ("grad_fused", "minf_fused", "grad_prb_fused"))
        per_sm, smem_bytes = fused.fft_launch_config(
            name, dev_i, g.ndet, planes,
            body=fused.fft_body(g.ndet, g.nmodes))
        regs, old = fft_regs[name], gemm_regs[name]
        check(fft_ms < gemm_ms, (name, fft_ms, gemm_ms))
        variant_lines[name] = gemm_ms
        log("kernel", f"headline {g} {name}: variant 'fft' {fft_ms:.3f} ms, "
            f"forced 'gemm' {gemm_ms:.3f} ms (5 back-to-back launches each, "
            f"in turns gemm, fft, fft, gemm: {gemm_ms / fft_ms:.1f}x), "
            f"bound {bounds[name][0]:.3f} ms by {bounds[name][1]} "
            f"({100 * bounds[name][0] / fft_ms:.1f}% of it reached, 'gemm' "
            f"{100 * bounds[name][0] / gemm_ms:.1f}%), plain "
            f"{results[name][2]:.3f} ms; 'fft' {regs['registers']} "
            f"registers, "
            f"{regs['spill_stores'] + regs['spill_loads']} spill bytes, "
            f"{smem_bytes} B dynamic + {regs['smem']} B static shared memory, "
            f"{per_sm} block/SM; 'gemm' {old['registers']} registers, "
            f"{old['spill_stores'] + old['spill_loads']} spill bytes; on "
            f"{card}")
    # adj at the stream path's own frames a launch (a chunk of config 3):
    # the tail of 1024 frames over the card's blocks.
    few = slice(0, STREAM_FRAMES)
    base_few, scan_few = base[:, few], scan_i[:, few]
    adj_few = in_turns_ms(
        torch, timer, f"adj {STREAM_FRAMES}",
        lambda: fused._adj_cuda(base_few, scan_few, prb, g.nz, g.n,
                                variant="fft"),
        lambda: fused._adj_cuda(base_few, scan_few, prb, g.nz, g.n,
                                variant="gemm"))
    few_bound = bound(fft_flops(scan_few, g.nmodes, g.ndet, 1),
                      nbytes(base_few, scan_few, prb, psi_r))
    check(adj_few[0] < adj_few[1], ("adj", STREAM_FRAMES, adj_few))
    log("kernel", f"adj at {STREAM_FRAMES} frames (the stream path's "
        f"launch): 'fft' {adj_few[0]:.3f} ms, forced 'gemm' "
        f"{adj_few[1]:.3f} ms in turns ({adj_few[1] / adj_few[0]:.1f}x), "
        f"bound {few_bound[0]:.3f} ms by {few_bound[1]} "
        f"({100 * few_bound[0] / adj_few[0]:.1f}% of it reached); on {card}")
    # adj in scan order (its frames, then the tile scatter) against the
    # one-pass FFT kernel with fp32 atomics it replaced, in turns, at the
    # headline's and the stream path's frames; both variants bitwise
    # repeatable at 1024 frames too (the headline's are held above).
    adj_atomic = {}
    for frames, far_t, scan_t in ((g.nscan, base, scan_i),
                                  (STREAM_FRAMES, base_few, scan_few)):
        for v in ("fft", "gemm"):
            check(torch.equal(
                fused._adj_cuda(far_t, scan_t, prb, g.nz, g.n, variant=v),
                fused._adj_cuda(far_t, scan_t, prb, g.nz, g.n, variant=v)),
                  ("adj is not bitwise repeatable", v, frames))
        atomic = fused._adj_cuda(far_t, scan_t, prb, g.nz, g.n,
                                 variant="atomic")
        order_err = rel_err(torch, atomic, fused.adj(far_t, scan_t, prb,
                                                     g.nz, g.n))[0]
        check(order_err <= SCATTER_ORDER_TOL, ("adj vs atomic", order_err))
        adj_atomic[frames] = in_turns_ms(
            torch, timer, f"adj atomic {frames}",
            lambda: fused._adj_cuda(far_t, scan_t, prb, g.nz, g.n),
            lambda: fused._adj_cuda(far_t, scan_t, prb, g.nz, g.n,
                                    variant="atomic"))
        new_ms, old_ms = adj_atomic[frames]
        log("kernel", f"adj at {frames} frames: in scan order (frames of "
            f"{fused.adj_chunk(1, frames, 1, g.nprb)} positions a chunk, then "
            f"the tile scatter) {new_ms:.3f} ms against the forced atomic "
            f"kernel {old_ms:.3f} ms, in turns ({new_ms / old_ms:.2f}x), "
            f"the two within {order_err:.2e} of scale; both variants "
            f"bitwise repeatable; on {card}")
    adj_atomic_ms = adj_atomic[g.nscan][1]
    # grad_fused and adj_residual in scan order (the frame kernel on each
    # chunk of frames, then the tile scatter, chunk after chunk), at the
    # headline's and the stream path's frames: bitwise repeatable on both
    # variants and the same bits whatever the chunk, within
    # SCATTER_ORDER_TOL of the forced one-pass atomic kernel they replaced,
    # whose objective they keep bit for bit; grad_fused's gradient is
    # adj_residual's of fwd's farplane bit for bit; then the two passes
    # against the atomic kernel in turns at SCAN_ORDER_BUDGETS of scratch.
    scan_order = {}
    for frames in (g.nscan, STREAM_FRAMES):
        a_t = (psi_r, data[:, :frames].contiguous(),
               scan_i[:, :frames].contiguous(), prb)
        far_t = fused.fwd(psi_r, a_t[2], prb, g.ndet)
        runs = {"grad_fused": lambda **kw: fused._grad_fused_cuda(
                    *a_t, g.ndet, "gaussian", None, **kw),
                "adj_residual": lambda **kw: fused._adj_residual_cuda(
                    far_t, a_t[1], a_t[2], prb, g.nz, g.n, "gaussian", **kw)}
        for name, fn in runs.items():
            got, f_got = fn()
            for v in ("fft", "gemm"):
                (x, f_x), (y, f_y) = fn(variant=v), fn(variant=v)
                check(torch.equal(x, y) and float(f_x) == float(f_y),
                      (name, "not bitwise repeatable", v, frames))
            for chunk in (1000, frames):
                x, f_x = fn(chunk=chunk)
                check(torch.equal(x, got) and float(f_x) == float(f_got),
                      (name, "the bits depend on the chunk", chunk, frames))
            old, f_old = fn(variant="atomic")
            order_err = rel_err(torch, old, got)[0]
            check(order_err <= SCATTER_ORDER_TOL
                  and float(f_old) == float(f_got),
                  (name, "vs atomic", order_err, float(f_old), float(f_got)))
            times = {}
            for mib in SCAN_ORDER_BUDGETS:
                chunk = mib * 2**20 // (g.nmodes * g.nprb**2 * 8)
                times[mib] = in_turns_ms(
                    torch, timer, f"{name} scan order {frames} {mib}",
                    lambda: fn(chunk=chunk), lambda: fn(variant="atomic"))
            scan_order[name, frames] = times
            log("kernel", f"{name} at {frames} frames in scan order (frames "
                "of a chunk, then the tile scatter): bitwise repeatable on "
                "both variants and the same bits at chunks of 1000 and "
                f"{frames} frames, within {order_err:.2e} of scale of the "
                "forced atomic kernel with its objective bit for bit; in "
                "turns against it: " + ", ".join(
                    f"{mib} MiB scratch ({mib * 2**20 // (g.nprb**2 * 8)} "
                    f"frames a chunk) {n_ms:.3f} / atomic {o_ms:.3f} ms "
                    f"({n_ms / o_ms:.2f}x)"
                    for mib, (n_ms, o_ms) in times.items())
                + f"; on {card}")
        check(torch.equal(runs["grad_fused"]()[0], runs["adj_residual"]()[0]),
              ("grad_fused(psi) is not adj_residual(fwd(psi))", frames))
        del a_t, far_t, runs
    default_mib = fused.FRAME_SCRATCH_BYTES // 2**20
    scan_order_atomic_ms = {name: scan_order[name, g.nscan][default_mib][1]
                            for name in ("grad_fused", "adj_residual")}
    log("kernel", "grad_fused(psi)'s gradient equals adj_residual(fwd(psi))'s "
        f"bit for bit at {g.nscan} and {STREAM_FRAMES} frames ('fft': the "
        "same inverse half)")
    body_turns = grad_fused_bodies(torch, fused, timer, g, psi_r, data,
                                   scan_i, prb, base,
                                   bounds["grad_fused"][0], card)
    minf_turns = minf_fused_bodies(torch, fused, timer, g, psi_r, data,
                                   scan_i, prb, base, card)
    # The 'fft' operators against a complex128 oracle on the card: the
    # reference's operator accuracy is ~4e-7 for its fused_hp tier (~8e-6
    # for fused_mp / fused_mx), and every fused tier maps to these kernels,
    # so fused_hp's bound is held. grad_fused's gradient is adj_residual's
    # of fwd's farplane (bit for bit), so its oracle is adj_residual's in
    # complex128 on that farplane.
    gen_o = torch.Generator(device=dev).manual_seed(SEED + 5)
    for ndet, nmodes in ((64, 1), (64, 4), (128, 1), (128, 4)):
        go = Geometry(nz=512, n=512, nscan=1024, ndet=ndet, nprb=ndet,
                      nmodes=nmodes)
        _, scan_o, prb_o, data_o = make_problem(gen_o, go, device=dev)
        scan_oi = scan_to_int(scan_o)
        psi_o = crandn(*go.psi_shape, generator=gen_o)
        far_o = crandn(*go.farplane_shape, generator=gen_o)
        c128 = [x.to(torch.complex128) for x in (psi_o, prb_o, far_o)]
        hp_errs = {
            "fwd": rel_err(torch, fused.fwd(psi_o, scan_oi, prb_o, ndet),
                           diffraction.fwd_raw(c128[0], scan_oi, c128[1],
                                               ndet, "xla"))[0],
            "adj": rel_err(torch, fused.adj(far_o, scan_oi, prb_o, go.nz,
                                            go.n),
                           diffraction.adj_raw(c128[2], scan_oi, c128[1],
                                               go.nz, go.n, "xla"))[0],
            "adj_probe": rel_err(torch, fused.adj_probe(far_o, scan_oi, psi_o,
                                                        go.nprb),
                                 diffraction.adj_probe_raw(
                                     c128[2], scan_oi, c128[0], go.nprb,
                                     "xla"))[0]}
        far_po = fused.fwd(psi_o, scan_oi, prb_o, ndet)
        grad_o = fused.grad_fused(psi_o, data_o, scan_oi, prb_o, ndet,
                                  "gaussian")[0]
        check(torch.equal(grad_o, fused.adj_residual(
            far_po, data_o, scan_oi, prb_o, go.nz, go.n, "gaussian")[0]),
              "grad_fused(psi) is not adj_residual(fwd(psi))")
        for name, got, far_c in (
                ("adj_residual", fused.adj_residual(
                    far_o, data_o, scan_oi, prb_o, go.nz, go.n,
                    "gaussian")[0], c128[2]),
                ("grad_fused", grad_o, far_po.to(torch.complex128))):
            hp_errs[name] = rel_err(torch, got, fused.adj_residual_reference(
                far_c, data_o.double(), scan_oi, c128[1], go.nz, go.n,
                "gaussian")[0])[0]
        check(fused.fwd.variant == fused.adj.variant
              == fused.adj_probe.variant == fused.adj_residual.variant
              == fused.grad_fused.variant == "fft", "not the 'fft' variant")
        check(all(e <= HP_BOUND for e in hp_errs.values()),
              ("fused_hp's operator bound", hp_errs))
        log("kernel", f"tier accuracy {go}: against a complex128 oracle on "
            "the card, max|err| / max|ref| " + ", ".join(
                f"{k} {e:.2e}" for k, e in hp_errs.items())
            + f"; fused_hp bound {HP_BOUND:g} met; on {card}")
        del far_po, grad_o
    fd = fused.fwd(dpsi_h, scan_i, prb, g.ndet)
    ls_err, ls_abs = compare_ls(torch, linesearch, far, fd, data,
                                "gaussian")
    ms = median_ms(torch, lambda: linesearch.ls_objectives(
        far, fd, data, LS_STEPS, "gaussian"), 10)
    plain_ms = median_ms(torch, lambda: linesearch.ls_objectives_reference(
        far, fd, data, LS_STEPS, "gaussian"), 10)
    results["ls_objectives"] = (ls_abs, ms, plain_ms)
    bounds["ls_objectives"] = bound(
        ls_flops(data, g.nmodes, len(LS_STEPS)),
        nbytes(far, fd, data) + 8 * len(LS_STEPS))
    # The K square roots (or logarithms) of a pixel on the special-function
    # units, at the card's highest SM clock: under the byte bound.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sfu_ms = 1e3 * len(LS_STEPS) * data.numel() / (
        SFU_PER_SM_CLOCK * sms * sm_mhz * 1e6)
    log("kernel", f"headline {g} ls_objectives at {len(LS_STEPS)} steps: "
        f"err {ls_err:.2e} (bitwise repeatable); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bounds['ls_objectives'][0]:.3f} ms by "
        f"{bounds['ls_objectives'][1]} (the {len(LS_STEPS)} x "
        f"{data.numel()} special-function results alone {sfu_ms:.3f} ms at "
        f"{SFU_PER_SM_CLOCK} a clock per SM and {sm_mhz:g} MHz), median of "
        f"10 on {card}")
    # One step (the same read of both farplanes and the data, so the
    # difference at 17 steps is the per-step work) and the solver's 17.
    ls_times = {(model, len(steps)): median_ms(
        torch, lambda: linesearch.ls_objectives(far, fd, data, steps, model),
        5) for model in ("gaussian", "poisson")
        for steps in (LS_STEPS[:1], LS_STEPS)}
    ls_regs = kernel_report(cuda_build, built["ls_objectives"][2], LS_ENTRY)
    per_sm = _launch.blocks_per_sm(
        "ls_objectives", "tk_ls_objectives_frame_blocks_per_sm", dev.index,
        linesearch.step_bucket(len(LS_STEPS)))
    log("kernel", f"headline {g} ls_objectives, median of 5: " + "; ".join(
            f"{model} {k} step{'s' if k > 1 else ''} {ms:.3f} ms "
            f"({100 * bounds['ls_objectives'][0] / ms:.1f}% of the bound "
            "reached)"
            for (model, k), ms in ls_times.items())
        + f"; at {len(LS_STEPS)} steps {ls_regs['registers']} registers, "
        f"{ls_regs['spill_stores'] + ls_regs['spill_loads']} spill bytes, "
        f"{ls_regs['smem']} B static shared memory, {per_sm} blocks of 256 "
        f"threads/SM; on {card}")
    # The hybrid tier's kernels on the same object, probe and frames (the
    # detector is the probe's size here, so the frames are contiguous).
    h_errs = compare_hybrid(torch, kernels, psi_r, scan_i, prb, base)
    pixels = base.numel()  # frame pixels of every mode
    for name, fn, plain_fn, moved, flop in (
            ("gather_probe_mul",
             lambda: kernels.gather_probe_mul(psi_r, scan_i, prb),
             lambda: kernels.gather_probe_mul_reference(psi_r, scan_i, prb),
             nbytes(psi_r, prb, scan_i, base), 6),
            ("scatter_conj_probe",
             lambda: kernels.scatter_conj_probe(base, scan_i, prb, g.nz, g.n),
             lambda: kernels.scatter_conj_probe_reference(base, scan_i, prb,
                                                          g.nz, g.n),
             nbytes(base, prb, scan_i, psi_r), 8),
            ("adj_probe_reduce",
             lambda: kernels.adj_probe_reduce(base, scan_i, psi_r),
             lambda: kernels.adj_probe_reduce_reference(base, scan_i, psi_r),
             nbytes(base, psi_r, scan_i, prb), 8)):
        ms = median_ms(torch, fn, 10)
        plain_ms = median_ms(torch, plain_fn, 10)
        results[name] = (h_errs[name][1], ms, plain_ms)
        # One complex multiply (6 operations), and for the adjoints one
        # complex add (2), per frame pixel and mode.
        bounds[name] = bound(flop * pixels, moved)
        log("kernel", f"headline {g} {name}: err {h_errs[name][0]:.2e}; "
            f"kernel {ms:.3f} ms ({moved / ms / 1e9:.3f} TB/s of its bytes), "
            f"plain {plain_ms:.3f} ms, bound {bounds[name][0]:.3f} ms, "
            f"median of 10 on {card}")
    # gather_probe_mul on the headline with one position masked, then
    # timed at the hybrid path's frames (16384) and at the facade's and
    # options' (4096).
    scan_m = scan_i.clone()
    scan_m[0, 5, 0] = -1
    check(gather_repeatable(torch, kernels, psi_r, scan_m, prb) == 1,
          "one masked position")
    scatter_head = scatter_as_tile(torch, kernels, base, scan_m, prb, g.nz,
                                   g.n)
    del scan_m
    gather_times = {}
    for frames in (g.nscan, CONFIG3_FRAMES):
        part = scan_i[:, :frames]
        out_bytes = 8 * g.ntheta * frames * g.nmodes * g.nprb**2
        gather_times[frames] = (
            median_ms(torch, lambda: kernels.gather_probe_mul(psi_r, part,
                                                              prb), 5),
            bound(6 * out_bytes / 8, nbytes(psi_r, prb, part) + out_bytes))
    g_regs = kernel_report(cuda_build, built["gather_probe_mul"][2],
                           GATHER_ENTRY)
    log("kernel", f"headline {g} gather_probe_mul, median of 5: " + "; ".join(
            f"{frames} frames {ms:.3f} ms (bound {bnd[0]:.3f} ms, "
            f"{100 * bnd[0] / ms:.1f}% of it reached)"
            for frames, (ms, bnd) in gather_times.items())
        + f"; {g_regs['registers']} registers, "
        f"{g_regs['spill_stores'] + g_regs['spill_loads']} spill bytes; "
        f"bitwise repeatable on the headline with one position masked; on "
        f"{card}")
    # scatter_conj_probe's tile kernel against the atomic kernel it
    # replaced, in turns, at the same two frame counts.
    scatter_turns, scatter_bounds = {}, {}
    tile0 = kernels.SCATTER_TILE
    s_per_sm = scatter_blocks_per_sm(_launch, kernels, dev.index, g.nmodes)
    for frames in (g.nscan, CONFIG3_FRAMES):
        part, near_p = scan_i[:, :frames], base[:, :frames]
        scatter_bounds[frames] = bound(
            8 * near_p.numel(), nbytes(near_p, prb, part, psi_r))
        scatter_turns[frames] = in_turns_ms(
            torch, timer, f"scatter_conj_probe {frames}",
            lambda: kernels.scatter_conj_probe(near_p, part, prb, g.nz, g.n),
            lambda: kernels._scatter_conj_probe_cuda(
                near_p, part, prb, g.nz, g.n, variant="atomic"))
    check(all(new < old for new, old in scatter_turns.values()),
          ("scatter_conj_probe: the tile kernel is not faster",
           scatter_turns))
    scatter_atomic_ms = scatter_turns[g.nscan][1]
    s_regs = kernel_report(cuda_build, built["scatter_conj_probe"][2],
                           scatter_entry(kernels, g.nmodes))
    s_old = kernel_report(cuda_build, built["scatter_conj_probe"][2],
                          SCATTER_ATOMIC_ENTRY)
    tiles_y, tiles_x, _ = kernels.scatter_tile_plan(g.ntheta, g.nz, g.n)
    # Walked whole (no chunk skip), the scan is read once a tile: its bytes
    # against the frames'.
    walk = tiles_y * tiles_x / (g.nmodes * g.nprb**2)
    log("kernel", f"headline {g} scatter_conj_probe: tile ({tile0[0]}x"
        f"{tile0[1]}) / "
        "forced atomic kernel, 5 "
        "back-to-back launches each in turns atomic, tile, tile, atomic: "
        + "; ".join(
            f"{frames} frames {new:.3f} / {old:.3f} ms ({old / new:.1f}x, "
            f"bound {scatter_bounds[frames][0]:.3f} ms, "
            f"{100 * scatter_bounds[frames][0] / new:.1f}% of it reached)"
            for frames, (new, old) in scatter_turns.items())
        + f"; tile {s_regs['registers']} registers, "
        f"{s_regs['spill_stores'] + s_regs['spill_loads']} spill bytes, "
        f"{s_regs['smem']} B static shared memory, {s_per_sm} blocks/SM; "
        f"atomic {s_old['registers']} registers; walked whole, the scan reads "
        f"{100 * walk:.2f}% of the frame bytes ({tiles_y * tiles_x} tiles); "
        "err against the plain version / the atomic kernel on the headline "
        f"with one position masked {scatter_head[0]:.2e}/"
        f"{scatter_head[1]:.2e}; bitwise repeatable; on {card}")
    from tikejax_torch.ops import lbfgs

    lb_results, lb_bounds, lb_compact = compare_lbfgs(torch, lbfgs, dev)
    results.update(lb_results)
    bounds.update(lb_bounds)
    log("kernel", f"L-BFGS direction at {LBFGS_SHAPE} complex64, m = "
        f"{LBFGS_M}: " + "; ".join(
            f"{name} err {lb_results[name][0]:.2e} against the plain "
            f"version, bitwise repeatable, {lb_results[name][1]:.4f} ms "
            f"(bound {lb_bounds[name][0]:.4f} ms by {lb_bounds[name][1]}, "
            f"{100 * lb_bounds[name][0] / lb_results[name][1]:.1f}% of it "
            f"reached), plain {lb_results[name][2]:.4f} ms, compact plain "
            + ", ".join(f"{k} {v[0]:.4f} ms (rel err {v[1]:.2e})"
                        for k, v in lb_compact[name].items())
            for name in LBFGS_WRAPPERS) + f"; median of 20 on {card}")
    log("kernel", "bounds (ms, by): " + ", ".join(
        f"{k} {v[0]:.3f} {v[1]}" for k, v in bounds.items()))
    del base, psi_r, args, far, fd, dpsi_h

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

    counters, plain = kernel_counters()
    fused_counters = counters[:9]  # all but the hybrid tier's three

    def reset_counts():
        for fn in counters + plain:
            fn.launches = 0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        return held

    # -- 5. the main path: solvers.run -------------------------------------
    run(data, psi0, scan, prb, g, piter=3)  # warm-up
    held = reset_counts()
    bodies = dict(fused.grad_fused.body_launches)
    t0 = time.perf_counter()
    psi, _, m = run(data, psi0, scan, prb, g, piter=MAIN_ITERS,
                    model="gaussian")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    main_counts = {fn.__name__: fn.launches for fn in counters}
    main_launches = fused.grad_fused.launches
    main_chunks = frame_launches(fused, *shape(g))
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    check(main_launches == m["evaluations"] * main_chunks > 0,
          (main_launches, m["evaluations"], main_chunks))
    main_bodies = body_delta(fused.grad_fused, bodies)
    check(main_bodies == {"fft_regs": main_launches}, main_bodies)
    iters = int(m["iters_run"])
    minf = m["minf"][:iters].cpu()
    res = m["residual"][:iters].cpu()
    check(psi.shape == g.psi_shape and bool(torch.isfinite(psi).all()),
          "psi shape or finiteness")
    check(float(minf[-1]) < float(minf[0]), minf)
    check(float(res[-1]) <= 0.1 * float(res[0]), res)
    main_peak = MAIN_PEAK + fused.FRAME_SCRATCH_BYTES
    check(peak <= main_peak, f"peak extra memory {peak} bytes")
    check(fused.grad_fused.variant == "fft", fused.grad_fused.variant)
    log("main", f"{g} gaussian, solver defaults, grad_fused variant "
        f"'{fused.grad_fused.variant}', {iters} iters in "
        f"{seconds:.3f} s: {iters / seconds:.2f} iters/s, "
        f"{1e3 * seconds / iters:.2f} ms/iter, "
        f"{m['evaluations'] / iters:.2f} evals/iter, "
        f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
        f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, peak extra memory "
        f"{peak / 2**20:.1f} MiB (limit {main_peak / 2**20:.1f}: the "
        f"'gemm' variant's {MAIN_PEAK / 2**20:.1f} and the frame scratch), "
        f"grad_fused launches {main_launches} ({main_chunks} chunks of "
        f"frames an evaluation; by body {main_bodies}), on {card}")
    del psi, m

    # Per-stage wall time of reconstruct's solver calls (each ends in a
    # host read; the synchronise makes the boundary exact).
    timed = []
    real_run = cg.run

    def timed_run(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_run(*a, **k)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t)
        return out

    cg.run = timed_run

    # -- 6. deep: reconstruct to 1e-6 on the headline ----------------------
    held = reset_counts()
    bodies = dict(fused.grad_fused.body_launches)
    t0 = time.perf_counter()
    psi, _, stages = reconstruct(data, psi0, scan, prb, g,
                                 target_residual=DEEP_TARGET,
                                 max_segments=DEEP_MAX_SEGMENTS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    deep = {fn.__name__: fn.launches for fn in counters}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    iters = [int(mm["iters_run"]) for _, mm in stages]
    # One combination every refinement (L-BFGS) iteration; one Gram pass
    # every direction after an accepted step: within a segment, and at its
    # start where it carries one.
    refine = [(mm, k) for (name, mm), k in zip(stages, iters)
              if name.startswith("split:")]
    accepted = sum(sum(v > 0 for v in mm["gamma"][:k - 1].tolist())
                   for mm, k in refine)
    check(deep["lbfgs_combine"] == sum(k for _, k in refine) > 0
          and accepted <= deep["lbfgs_gram"] <= accepted + len(refine),
          (deep, accepted, len(refine)))
    evals = sum(mm["evaluations"] for _, mm in stages)
    syncs = sum(mm["host_syncs"] for _, mm in stages)
    n_split = sum(1 for name, _ in stages if name.startswith("split:"))
    res_end = final_residual(stages)
    check(bool(torch.isfinite(psi).all()), "psi finiteness")
    check(res_end <= DEEP_TARGET, f"deep residual {res_end:.4e} > "
          f"{DEEP_TARGET:g} after {len(stages)} stages")
    check(deep["grad_fused"] == evals * main_chunks > 0, (deep, evals))
    deep_bodies = body_delta(fused.grad_fused, bodies)
    check(deep_bodies == {"fft_regs": deep["grad_fused"]}, deep_bodies)
    check(fused.grad_fused.variant == "fft", fused.grad_fused.variant)
    # The reuse safeguard: the first two segments freeze their base, then
    # every Anderson step makes both candidates' farplanes and hands the
    # winner forward as the next base.
    check(n_split >= 2 and deep["fwd"] == 2 * n_split, (deep, n_split))
    check(deep["minf_fused"] == 0, deep)
    check(fused.fwd.variant == "fft", fused.fwd.variant)
    split_s = sum(t for (name, _), t in zip(stages, timed[-len(stages):])
                  if name.startswith("split:"))
    split_iters = sum(k for (name, _), k in zip(stages, iters)
                      if name.startswith("split:"))
    log("deep", f"{g} gaussian, reconstruct(target_residual="
        f"{DEEP_TARGET:g}) defaults from psi0 = ones, grad_fused and fwd "
        f"on '{fused.grad_fused.variant}': {seconds:.3f} s, "
        f"{sum(iters)} iters in {len(stages)} stages "
        f"{[f'{n}:{k}' for (n, _), k in zip(stages, iters)]}, final "
        f"residual {res_end:.4e}, {evals / sum(iters):.3f} evals/iter, "
        f"{syncs / sum(iters):.3f} host syncs/iter, refinement segments "
        f"{split_iters / split_s:.2f} iters/s ({split_iters} iters in "
        f"{split_s:.3f} s), stage 1 {timed[-len(stages)]:.3f} s, peak "
        f"extra memory {peak / 2**30:.3f} GiB, launches {deep} (grad_fused "
        f"by body {deep_bodies}; lbfgs_gram "
        f"bound {1e3 * bounds['lbfgs_gram'][0]:.1f} us, lbfgs_combine "
        f"{1e3 * bounds['lbfgs_combine'][0]:.1f} us; {accepted} accepted "
        f"refinement steps), on {card}")
    deep_summary = (seconds, sum(iters), len(stages))
    del psi, stages

    # -- 7. materialized: G psi kept, fwd + adj_residual + fwd_quad_stats ---
    far_bytes = math.prod(g.farplane_shape) * 8
    mat_peak = far_bytes + 3 * nbytes(data) + 2**29
    run(data, psi0, scan, prb, g, piter=3, memory="materialized")  # warm-up
    held = reset_counts()
    t0 = time.perf_counter()
    psi, _, m = run(data, psi0, scan, prb, g, piter=MAIN_ITERS,
                    memory="materialized")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    mat = {fn.__name__: fn.launches for fn in counters}
    mat_ms = 1e3 * seconds / int(m["iters_run"])
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    iters = int(m["iters_run"])
    res = m["residual"][:iters].cpu()
    check(psi.shape == g.psi_shape and bool(torch.isfinite(psi).all()),
          "psi shape or finiteness")
    check(mat["fwd"] == mat["fwd_quad_stats"] == iters > 0
          and mat["adj_residual"] == iters * main_chunks, mat)
    check(mat["grad_fused"] == mat["minf_fused"]
          == mat["ls_objectives"] == 0, mat)
    check(float(res[-1]) <= 0.1 * float(res[0]), res)
    check(peak < mat_peak, f"peak extra memory {peak} bytes")
    check(fused.fwd.variant == fused.adj_residual.variant
          == fused.fwd_quad_stats.variant == "fft",
          (fused.fwd.variant, fused.adj_residual.variant,
           fused.fwd_quad_stats.variant))
    log("materialized", f"{g} gaussian, run(memory='materialized'), fwd, "
        f"adj_residual and fwd_quad_stats on 'fft', {iters} "
        f"iters in {seconds:.3f} s: {iters / seconds:.2f} iters/s, "
        f"{1e3 * seconds / iters:.2f} ms/iter, "
        f"{m['evaluations'] / iters:.2f} evals/iter, "
        f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
        f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, peak extra memory "
        f"{peak / 2**30:.3f} GiB (limit {mat_peak / 2**30:.2f}), launches "
        f"{mat}, on {card}")
    del psi, m
    busy = device_busy(torch, lambda: run(data, psi0, scan, prb, g,
                                          piter=PROFILE_ITERS,
                                          memory="materialized"))
    log("materialized", show_busy(PROFILE_ITERS, busy, mat_ms) + f"; on {card}")

    # -- 8. fused-ls: one ls_objectives pass a line search -----------------
    fls_peak = 2 * far_bytes + 2**29
    run(data, psi0, scan, prb, g, piter=3, memory="materialized",
        fused_linesearch=True)  # warm-up
    held = reset_counts()
    t0 = time.perf_counter()
    psi, _, m = run(data, psi0, scan, prb, g, piter=MAIN_ITERS,
                    memory="materialized", fused_linesearch=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    fls = {fn.__name__: fn.launches for fn in counters}
    fls_ms = 1e3 * seconds / int(m["iters_run"])
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    iters = int(m["iters_run"])
    res = m["residual"][:iters].cpu()
    check(psi.shape == g.psi_shape and bool(torch.isfinite(psi).all()),
          "psi shape or finiteness")
    check(fls["ls_objectives"] == iters > 0 and fls["fwd"] == 2 * iters
          and fls["adj_residual"] == iters * main_chunks, fls)
    check(fls["fwd_quad_stats"] == fls["grad_fused"] == fls["minf_fused"]
          == 0, fls)
    check(float(res[-1]) <= 0.1 * float(res[0]), res)
    check(peak < fls_peak, f"peak extra memory {peak} bytes")
    check(fused.fwd.variant == fused.adj_residual.variant == "fft",
          (fused.fwd.variant, fused.adj_residual.variant))
    log("fused-ls", f"{g} gaussian, run(memory='materialized', "
        f"fused_linesearch=True), fwd and adj_residual on 'fft', "
        f"ls_objectives frame-major, {iters} "
        f"iters in {seconds:.3f} s: "
        f"{iters / seconds:.2f} iters/s, {1e3 * seconds / iters:.2f} "
        f"ms/iter, {m['evaluations'] / iters:.2f} evals/iter, "
        f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
        f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, peak extra memory "
        f"{peak / 2**30:.3f} GiB (limit {fls_peak / 2**30:.2f}), launches "
        f"{fls}, on {card}")
    del psi, m
    busy = device_busy(torch, lambda: run(
        data, psi0, scan, prb, g, piter=PROFILE_ITERS, memory="materialized",
        fused_linesearch=True))
    log("fused-ls", show_busy(PROFILE_ITERS, busy, fls_ms) + f"; on {card}")

    # -- 9. hybrid: cuFFT between the patch kernels -------------------------
    # The classic body's peak is the line search: G psi (one farplane), the
    # direction's farplane (a second one) and the three statistics planes
    # made from the two: 2 + 2 + 3 GiB. Before that the gradient pass holds
    # G psi, its residual and the residual's inverse FFT, and each forward
    # pass a nearplane and its FFT beside G psi: three farplanes, less.
    # cuFFT takes no workspace worth counting at 128^2 (7.042 GiB measured).
    # The sum allowed is two farplanes, the statistics and 0.5 GiB.
    hyb_peak = 2 * far_bytes + 3 * nbytes(data) + 2**29
    run(data, psi0, scan, prb, g, piter=3, kernel="pallas")  # warm-up
    held = reset_counts()
    t0 = time.perf_counter()
    psi, _, m = run(data, psi0, scan, prb, g, piter=HYBRID_ITERS,
                    kernel="pallas")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    hyb = {fn.__name__: fn.launches for fn in counters}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    check(all(fn.launches == 0 for fn in fused_counters), hyb)
    iters = int(m["iters_run"])
    res = m["residual"][:iters].cpu()
    check(psi.shape == g.psi_shape and bool(torch.isfinite(psi).all()),
          "psi shape or finiteness")
    check(hyb["gather_probe_mul"] >= 2 * iters > 0
          and hyb["scatter_conj_probe"] == iters
          and hyb["adj_probe_reduce"] == 0, hyb)
    check(float(res[-1]) <= 0.1 * float(res[0]), res)
    check(peak < hyb_peak, f"peak extra memory {peak} bytes")
    log("hybrid", f"{g} gaussian, run(kernel='pallas'), {iters} iters in "
        f"{seconds:.3f} s: {iters / seconds:.2f} iters/s, "
        f"{1e3 * seconds / iters:.2f} ms/iter, "
        f"{m['evaluations'] / iters:.2f} evals/iter, "
        f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
        f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, peak extra memory "
        f"{peak / 2**30:.3f} GiB (limit {hyb_peak / 2**30:.2f}), launches "
        f"{hyb}, on {card}")
    # Where a hybrid iteration's time goes: the tier's three operators
    # (cuFFT between the patch kernels) and the classic body's PyTorch
    # passes between them, each alone at the headline size.
    far_h = diffraction.fwd_raw(psi, scan, prb, g.ndet, "pallas")
    minf_fn, resid_fn = likelihoods.get_model("gaussian")
    stats_h = cg._quad_stats(far_h, far_h)
    parts_ms = {
        "fwd": lambda: diffraction.fwd_raw(psi, scan, prb, g.ndet, "pallas"),
        "adj": lambda: diffraction.adj_raw(far_h, scan, prb, g.nz, g.n,
                                           "pallas"),
        "adj_probe": lambda: diffraction.adj_probe_raw(far_h, scan, psi,
                                                       g.nprb, "pallas"),
        "objective": lambda: cg._sum_over_positions(minf_fn, far_h, data),
        "residual": lambda: cg._map_over_positions(resid_fn, far_h, data),
        "statistics": lambda: cg._quad_stats(far_h, far_h),
        "candidate": lambda: cg._sum_over_positions(
            lambda a, b, c, d: cg._minf_of_gamma("gaussian", a, b, c, d,
                                                 0.5), *stats_h, data),
    }
    parts_ms = {k: median_ms(torch, fn, 5) for k, fn in parts_ms.items()}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    log("hybrid", "one pass of each part at the headline size, ms (median "
        "of 5): " + ", ".join(f"{k} {v:.3f}" for k, v in parts_ms.items())
        + f"; on {card}")
    del psi, m, data, scan, prb, far_h, stats_h

    # -- 10. frameless: 4 modes, the memory-bound safeguard ----------------
    g4 = Geometry(**FRAMELESS)
    _, scan4, prb4, data4 = make_problem(gen, g4, device=dev)
    psi4 = torch.ones(g4.psi_shape, dtype=torch.complex64, device=dev)
    base_bytes = math.prod(g4.farplane_shape) * 8
    # The kernels at this path's shapes, before it runs: an 8 GiB base
    # read as its split views, as the frameless safeguard hands it over.
    scan4_i = scan_to_int(scan4)
    psi_r4 = psi4 + 0.05 * crandn(*g4.psi_shape, generator=gen2)
    base4 = fused.fwd(0.5 * psi_r4, scan4_i, prb4, g4.ndet, split_out=True)
    via4 = fwd_feeds_minf(torch, fused, 0.5 * psi_r4, data4, scan4_i, prb4,
                          g4.ndet, base4)
    scale_errs = compare_at_scale(torch, fused, g4, psi_r4, data4, scan4_i,
                                  prb4, base4, SCALE_CHUNK)
    frames4 = fused._base_complex(base4)
    scale_errs.update(compare_hybrid_at_scale(
        torch, kernels, g4, psi_r4, scan4_i, prb4, frames4, SCALE_CHUNK))
    # scatter_conj_probe's tile kernel against the atomic one at 4 modes,
    # in turns: the tile kernel takes a position's modes 4 at a time.
    scatter4 = in_turns_ms(
        torch, timer, "scatter_conj_probe 4 modes",
        lambda: kernels.scatter_conj_probe(frames4, scan4_i, prb4, g4.nz,
                                           g4.n),
        lambda: kernels._scatter_conj_probe_cuda(
            frames4, scan4_i, prb4, g4.nz, g4.n, variant="atomic"))
    s4_regs = kernel_report(cuda_build, built["scatter_conj_probe"][2],
                            scatter_entry(kernels, g4.nmodes))
    s4_per_sm = scatter_blocks_per_sm(_launch, kernels, dev.index,
                                      g4.nmodes)
    # grad_fused and adj_residual at 4 modes in scan order (the 8 GiB base
    # as adj_residual's farplane): bitwise repeatable, the same bits with
    # 4096-frame chunks as with the default's 1024, within
    # SCATTER_ORDER_TOL of the forced atomic kernel, its objective bit for
    # bit.
    order4 = {}
    for name, fn in (
            ("grad_fused", lambda **kw: fused._grad_fused_cuda(
                psi_r4, data4, scan4_i, prb4, g4.ndet, "gaussian", None,
                **kw)),
            ("adj_residual", lambda **kw: fused._adj_residual_cuda(
                frames4, data4, scan4_i, prb4, g4.nz, g4.n, "gaussian",
                **kw))):
        got, f_got = fn()
        (x, f_x), (y, f_y) = fn(), fn(chunk=4096)
        check(torch.equal(x, got) and torch.equal(y, got)
              and float(f_x) == float(f_y) == float(f_got),
              (name, "4 modes: not the same bits"))
        old, f_old = fn(variant="atomic")
        order4[name] = rel_err(torch, old, got)[0]
        check(order4[name] <= SCATTER_ORDER_TOL
              and float(f_old) == float(f_got),
              (name, "4 modes vs atomic", order4[name]))
        del got, x, y, old
    del base4, psi_r4, frames4
    for name, (err, abs_err) in scale_errs.items():
        results[name] = (max(results[name][0], abs_err),) + results[name][1:]
    log("frameless", f"{g4} kernels against their plain versions (over "
        f"chunks of {SCALE_CHUNK} positions), with and without the split-"
        "view base: " + ", ".join(f"{k} err {e:.2e}"
                                  for k, (e, _) in scale_errs.items())
        + "; minf_fused of zeros on fwd's farplane ('fft') equal bit for "
        f"bit to minf_fused's objective ({via4:.9e}); scatter_conj_probe "
        "bitwise repeatable, its tile kernel / the forced atomic kernel in "
        f"turns {scatter4[0]:.3f} / {scatter4[1]:.3f} ms (the tile kernel's "
        f"4-mode build {s4_regs['registers']} registers, "
        f"{s4_regs['spill_stores'] + s4_regs['spill_loads']} spill bytes, "
        f"{s4_per_sm} blocks/SM); grad_fused and adj_residual in scan order "
        "bitwise repeatable and the same bits at chunks of 1024 and 4096 "
        "frames, against the forced atomic kernels " + ", ".join(
            f"{k} {e:.2e}" for k, e in order4.items())
        + f" of scale with their objectives bit for bit; on {card}")
    held = reset_counts()
    minf_bodies = dict(fused.minf_fused.body_launches)
    t0 = time.perf_counter()
    psi4, _, st4 = reconstruct(data4, psi4, scan4, prb4, g4,
                               target_residual=DEEP_TARGET, **FRAMELESS_KW)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    cg.run = real_run
    frameless = {fn.__name__: fn.launches for fn in counters}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    n_split = sum(1 for name, _ in st4 if name.startswith("split:"))
    evals = sum(mm["evaluations"] for _, mm in st4)
    res_start = float(st4[0][1]["residual"][0])
    res_end = final_residual(st4)
    check(bool(torch.isfinite(psi4).all()), "psi finiteness")
    check(n_split >= 2 and frameless["minf_fused"] == 2 * (n_split - 1),
          (frameless, n_split))
    # Every minf_fused launch on the body its shapes pick: at 4 modes the
    # shared-memory one.
    frameless_minf = body_delta(fused.minf_fused, minf_bodies)
    check(frameless_minf == {fused.fft_body(g4.ndet, g4.nmodes):
                             frameless["minf_fused"]}, frameless_minf)
    check(frameless["fwd"] == n_split and frameless["grad_fused"]
          == evals * frame_launches(fused, *shape(g4)),
          (frameless, n_split, evals))
    check(res_end < res_start, (res_start, res_end))
    check(peak < base_bytes + 1.5 * 2**30,
          f"peak extra memory {peak} bytes, base {base_bytes}")
    log("frameless", f"{g4} gaussian, reconstruct({FRAMELESS_KW}): "
        f"{seconds:.3f} s, {sum(int(mm['iters_run']) for _, mm in st4)} "
        f"iters in {len(st4)} stages, residual {res_start:.4e} -> "
        f"{res_end:.4e}, base farplane {base_bytes / 2**30:.2f} GiB, peak "
        f"extra memory {peak / 2**30:.3f} GiB, launches {frameless} "
        f"(minf_fused by body {frameless_minf}), on {card}")

    del psi4, st4, data4, scan4, prb4

    # -- 11. joint: BASELINE config 3 through run(recover_prb=True) --------
    g3 = Geometry(**CONFIG3)
    _, scan3, prb3, data3 = make_problem(gen, g3, device=dev)
    # The perturbation comes from its own generator (3% of max|prb|).
    gen3 = torch.Generator(device=dev).manual_seed(SEED + 2)
    prb3_p = prb3 + 0.03 * prb3.abs().max() * crandn(*g3.prb_shape,
                                                     generator=gen3)
    psi3 = torch.ones(g3.psi_shape, dtype=torch.complex64, device=dev)

    def probe_err(p):
        """max|c p - prb_true| with the least-squares complex c: the joint
        objective cannot tell (psi, prb) from (c psi, prb / c), so a
        recovered probe is compared up to that scale and phase; the raw
        max|p - prb_true| is printed beside it."""
        c = torch.vdot(p.reshape(-1), prb3.reshape(-1)) / torch.vdot(
            p.reshape(-1), p.reshape(-1))
        return float((c * p - prb3).abs().max())

    def raw_err(p):
        return float((p - prb3).abs().max())

    err0 = probe_err(prb3_p)
    run(data3, psi3, scan3, prb3_p, g3, piter=2, model="poisson",
        recover_prb=True)  # warm-up
    held = reset_counts()
    minf_bodies = dict(fused.minf_fused.body_launches)
    t0 = time.perf_counter()
    psi, prb_j, m = run(data3, psi3, scan3, prb3_p, g3, piter=JOINT_ITERS,
                        model="poisson", recover_prb=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    joint = {fn.__name__: fn.launches for fn in counters}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    iters = int(m["iters_run"])
    minf = m["minf"][:iters].cpu()
    res = m["residual"][:iters].cpu()
    check(bool(torch.isfinite(psi).all() and torch.isfinite(prb_j).all()),
          "psi or prb finiteness")
    check(float(minf[-1]) < float(minf[0]) and float(res[-1]) < float(res[0]),
          (minf, res))
    check(probe_err(prb_j) < err0, (probe_err(prb_j), err0))
    check(joint["grad_fused"] == joint["grad_prb_fused"] == iters > 0, joint)
    check(joint["minf_fused"] == m["evaluations"] - 2 * iters > 0,
          (joint, m["evaluations"]))
    # 128^2, one mode: every candidate on minf_fused's fused body.
    joint_minf = body_delta(fused.minf_fused, minf_bodies)
    check(joint_minf == {"fft_regs": joint["minf_fused"]}, joint_minf)
    check(peak < JOINT_PEAK + fused.FRAME_SCRATCH_BYTES,
          f"peak extra memory {peak} bytes")
    check(fused.grad_fused.variant == fused.minf_fused.variant
          == fused.grad_prb_fused.variant == "fft",
          (fused.grad_fused.variant, fused.minf_fused.variant,
           fused.grad_prb_fused.variant))
    log("joint", f"{g3} poisson, run(recover_prb=True), grad_fused, "
        f"minf_fused and grad_prb_fused on 'fft', {iters} iters in "
        f"{seconds:.3f} s: {iters / seconds:.2f} iters/s, "
        f"{m['evaluations'] / iters:.2f} evals/iter, "
        f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
        f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, probe error "
        f"{err0:.4e} -> {probe_err(prb_j):.4e} (raw {raw_err(prb3_p):.4e} "
        f"-> {raw_err(prb_j):.4e}), peak extra memory "
        f"{peak / 2**20:.1f} MiB, launches {joint} (minf_fused by body "
        f"{joint_minf}), on {card}")
    del psi, prb_j, m
    # The joint Poisson search amplifies any difference of rounding; with
    # every object scatter in scan order two one-rank runs on the default
    # tier are the same bits.
    reps = [run(data3, psi3, scan3, prb3_p, g3, piter=JOINT_REPEAT_ITERS,
                model="poisson", recover_prb=True) for _ in range(2)]
    check(torch.equal(reps[0][0], reps[1][0])
          and torch.equal(reps[0][1], reps[1][1])
          and reps[0][2]["evaluations"] == reps[1][2]["evaluations"]
          and torch.equal(reps[0][2]["minf"], reps[1][2]["minf"]),
          ("joint Poisson runs do not repeat",
           rel_err(torch, reps[0][0], reps[1][0])[0],
           reps[0][2]["evaluations"], reps[1][2]["evaluations"]))
    log("joint", f"{g3} poisson, run(recover_prb=True, piter="
        f"{JOINT_REPEAT_ITERS}) twice on the default tier: psi, prb and the "
        f"objectives equal bit for bit, {reps[0][2]['evaluations']} "
        "evaluations each")
    del reps

    # -- 12. materialized, joint: config 3 with G psi kept ------------------
    run(data3, psi3, scan3, prb3_p, g3, piter=2, model="poisson",
        recover_prb=True, memory="materialized")  # warm-up
    held = reset_counts()
    t0 = time.perf_counter()
    psi, prb_m, m = run(data3, psi3, scan3, prb3_p, g3,
                        piter=MATERIALIZED_JOINT_ITERS, model="poisson",
                        recover_prb=True, memory="materialized")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    matj = {fn.__name__: fn.launches for fn in counters}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    iters = int(m["iters_run"])
    minf = m["minf"][:iters].cpu()
    res = m["residual"][:iters].cpu()
    check(bool(torch.isfinite(psi).all() and torch.isfinite(prb_m).all()),
          "psi or prb finiteness")
    check(float(minf[-1]) < float(minf[0]), minf)
    check(probe_err(prb_m) < err0, (probe_err(prb_m), err0))
    check(matj["adj_residual"] == matj["adj_probe"] == iters > 0
          and matj["fwd"] == matj["fwd_quad_stats"] == 2 * iters, matj)
    check(matj["grad_fused"] == matj["grad_prb_fused"] == matj["minf_fused"]
          == matj["ls_objectives"] == 0, matj)
    check(peak < MATERIALIZED_JOINT_PEAK, f"peak extra memory {peak} bytes")
    check(fused.fwd.variant == fused.adj_residual.variant
          == fused.adj_probe.variant == fused.fwd_quad_stats.variant == "fft",
          (fused.fwd.variant, fused.adj_residual.variant,
           fused.adj_probe.variant, fused.fwd_quad_stats.variant))
    log("materialized", f"{g3} poisson, run(recover_prb=True, memory="
        f"'materialized'), fwd, adj_residual, adj_probe and fwd_quad_stats "
        f"on 'fft', "
        f"{iters} iters in {seconds:.3f} s: "
        f"{iters / seconds:.2f} iters/s, {m['evaluations'] / iters:.2f} "
        f"evals/iter, {m['host_syncs'] / iters:.2f} host syncs/iter, "
        f"residual {float(res[0]):.4e} -> {float(res[-1]):.4e}, probe error "
        f"{err0:.4e} -> {probe_err(prb_m):.4e} (raw {raw_err(prb3_p):.4e} "
        f"-> {raw_err(prb_m):.4e}), peak extra memory "
        f"{peak / 2**30:.3f} GiB (limit "
        f"{MATERIALIZED_JOINT_PEAK / 2**30:.2f}), launches {matj}, on {card}")
    del psi, prb_m, m

    # -- 13. stream: the quick start, nchunks = 4 ---------------------------
    run(data3, psi3, scan3, prb3_p, g3, piter=2, recover_prb=True,
        nchunks=STREAM_CHUNKS)  # warm-up
    held = reset_counts()
    t0 = time.perf_counter()
    psi, prb_s, m = run(data3, psi3, scan3, prb3_p, g3, piter=JOINT_ITERS,
                        recover_prb=True, nchunks=STREAM_CHUNKS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    stream = {fn.__name__: fn.launches for fn in counters}
    stream_ms = 1e3 * seconds / int(m["iters_run"])
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    iters = int(m["iters_run"])
    minf = m["minf"][:iters].cpu()
    res = m["residual"][:iters].cpu()
    passes = STREAM_CHUNKS * iters  # chunk passes of each step's gradient
    check(bool(torch.isfinite(psi).all() and torch.isfinite(prb_s).all()),
          "psi or prb finiteness")
    check(float(minf[-1]) < float(minf[0]), minf)
    # A streamed chunk's adj fits one frame-kernel launch (fused.adj_chunk).
    per_pass = -(-(g3.nscan // STREAM_CHUNKS) // fused.adj_chunk(
        g3.ntheta, g3.nscan // STREAM_CHUNKS, g3.nmodes, g3.nprb))
    check(per_pass == 1 and stream["adj"] == stream["adj_probe"] == passes > 0
          and stream["fwd"] == 6 * passes, (stream, passes, per_pass))
    check(stream["grad_fused"] == stream["grad_prb_fused"]
          == stream["minf_fused"] == stream["adj_residual"]
          == stream["fwd_quad_stats"] == stream["ls_objectives"] == 0,
          stream)
    check(peak < STREAM_PEAK, f"peak extra memory {peak} bytes")
    check(fused.adj_probe.variant == fused.fwd.variant == fused.adj.variant
          == "fft", (fused.adj_probe.variant, fused.fwd.variant,
                     fused.adj.variant))
    log("stream", f"{g3} gaussian, run(recover_prb=True, nchunks="
        f"{STREAM_CHUNKS}), fwd, adj and adj_probe on "
        f"'{fused.adj.variant}', "
        f"{iters} iters in {seconds:.3f} s: "
        f"{iters / seconds:.2f} iters/s, {m['evaluations'] / iters:.2f} "
        f"evals/iter, {m['host_syncs'] / iters:.2f} host syncs/iter, "
        f"residual {float(res[0]):.4e} -> {float(res[-1]):.4e}, "
        f"probe error {err0:.4e} -> {probe_err(prb_s):.4e} (raw "
        f"{raw_err(prb3_p):.4e} -> {raw_err(prb_s):.4e}), peak "
        f"extra memory {peak / 2**30:.3f} GiB (limit "
        f"{STREAM_PEAK / 2**30:.2f}), launches {stream}, on {card}")
    del psi, prb_s, m
    busy = device_busy(torch, lambda: run(
        data3, psi3, scan3, prb3_p, g3, piter=PROFILE_ITERS,
        recover_prb=True, nchunks=STREAM_CHUNKS))
    log("stream", show_busy(PROFILE_ITERS, busy, stream_ms) + f"; on {card}")

    # -- 14. joint-deep: reconstruct(recover_prb=True) to 1e-6 --------------
    held = reset_counts()
    minf_bodies = dict(fused.minf_fused.body_launches)
    t0 = time.perf_counter()
    psi, prb_d, stages = reconstruct(data3, psi3, scan3, prb3_p, g3,
                                     target_residual=DEEP_TARGET,
                                     recover_prb=True,
                                     max_segments=JOINT_DEEP_MAX_SEGMENTS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    jdeep = {fn.__name__: fn.launches for fn in counters}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    names = [name for name, _ in stages]
    iters = [int(mm["iters_run"]) for _, mm in stages]
    joint_iters = sum(k for name, k in zip(names, iters)
                      if name.endswith(":joint"))
    res_end = final_residual(stages)
    first_split = (names.index("split:fused") if "split:fused" in names
                   else len(names))
    refreshes = sum(1 for i in range(first_split, len(names))
                    if names[i].endswith(":joint")
                    and not names[i - 1].endswith(":joint"))
    check(bool(torch.isfinite(psi).all() and torch.isfinite(prb_d).all()),
          "psi or prb finiteness")
    check(names[0] == "fused:joint"
          and names[1:5] == ["fused_hp:joint"] * 4, names)
    check(jdeep["grad_prb_fused"] == joint_iters > 0, (jdeep, joint_iters))
    jdeep_minf = body_delta(fused.minf_fused, minf_bodies)
    check(jdeep_minf == {"fft_regs": jdeep["minf_fused"]}, jdeep_minf)
    check(probe_err(prb_d) < err0, (probe_err(prb_d), err0))
    log("joint-deep", f"{g3} gaussian, reconstruct(recover_prb=True, "
        f"target_residual={DEEP_TARGET:g}, max_segments="
        f"{JOINT_DEEP_MAX_SEGMENTS}) from psi0 = ones: {seconds:.3f} s, "
        f"{sum(iters)} iters ({joint_iters} joint) in {len(stages)} stages "
        f"{[f'{n}:{k}' for n, k in zip(names, iters)]}, final residual "
        f"{res_end:.4e}, probe refreshes {refreshes}, probe error "
        f"{err0:.4e} -> {probe_err(prb_d):.4e} (raw {raw_err(prb3_p):.4e} "
        f"-> {raw_err(prb_d):.4e}), peak extra memory "
        f"{peak / 2**30:.3f} GiB, launches {jdeep}, on {card}")
    # The segment budget it used (ROADMAP.md queue 3 item 3 counts the runs
    # that need more than JOINT_DEEP_MAX_SEGMENTS): each refinement segment
    # and each probe refresh takes one.
    n_split_j = sum(1 for name in names if name.startswith("split:"))
    log("joint-deep", f"segments used {n_split_j + refreshes} of "
        f"{JOINT_DEEP_MAX_SEGMENTS} ({n_split_j} refinement segments, "
        f"{refreshes} probe refreshes)")
    check(res_end <= DEEP_TARGET, f"joint-deep residual {res_end:.4e} > "
          f"{DEEP_TARGET:g} after {len(stages)} stages")

    del psi, prb_d, stages

    # -- 15. facade: numpy in, numpy out, on the hybrid tier ----------------
    dims = dict(ntheta=g3.ntheta, nz=g3.nz, n=g3.n, nscan=g3.nscan,
                ndet=g3.ndet, nprb=g3.nprb, nmodes=g3.nmodes)
    solver = compat.CGPtychoSolver(**dims, kernel="pallas")
    data_np, psi_np, scan_np, prb_np = (x.cpu().numpy() for x in (
        data3, psi3, scan3, prb3_p[:, 0]))  # a mode-less probe
    solver.run(data_np, psi_np, scan_np, prb_np, piter=2, model="poisson",
               recover_prb=True)  # warm-up
    reset_counts()
    t0 = time.perf_counter()
    out = solver.run(data_np, psi_np, scan_np, prb_np, piter=FACADE_ITERS,
                     model="poisson", recover_prb=True)
    seconds = time.perf_counter() - t0  # ends on the host: numpy came back
    fac = {fn.__name__: fn.launches for fn in counters}
    check(all(fn.launches == 0 for fn in plain), "plain version ran")
    check(all(fn.launches == 0 for fn in fused_counters), fac)
    check(all(type(v).__module__ == "numpy" for v in out.values()),
          {k: type(v) for k, v in out.items()})
    iters = int(out["iters_run"])
    prb_f = torch.from_numpy(out["prb"]).to(dev)
    check(out["psi"].shape == g3.psi_shape and out["prb"].shape
          == g3.prb_shape and bool(np.isfinite(out["psi"]).all()
                                   and np.isfinite(out["prb"]).all()),
          "psi or prb shape or finiteness")
    check(out["minf"][iters - 1] < out["minf"][0]
          and out["residual"][iters - 1] < out["residual"][0],
          (out["minf"], out["residual"]))
    check(probe_err(prb_f) < err0, (probe_err(prb_f), err0))
    check(fac["gather_probe_mul"] == 4 * iters > 0
          and fac["scatter_conj_probe"] == fac["adj_probe_reduce"] == iters,
          fac)
    log("facade", f"{g3} poisson, compat.CGPtychoSolver(kernel='pallas')"
        f".run(recover_prb=True) from numpy arrays (scan checked by "
        f"native.have_native() = {native.have_native()}), {iters} iters in "
        f"{seconds:.3f} s with both copies: {iters / seconds:.2f} iters/s, "
        f"{int(out['evaluations']) / iters:.2f} evals/iter, "
        f"{int(out['host_syncs']) / iters:.2f} host syncs/iter, residual "
        f"{out['residual'][0]:.4e} -> {out['residual'][iters - 1]:.4e}, "
        f"probe error {err0:.4e} -> {probe_err(prb_f):.4e}, launches {fac}, "
        f"on {card}")
    del out, prb_f, data_np, psi_np
    # The facade's operators on the small awkward case (the crop strided),
    # numpy in and out; the inner products in complex128 on the host.
    op = compat.CGPtychoSolver(
        ntheta=small.ntheta, nz=small.nz, n=small.n, nscan=small.nscan,
        ndet=small.ndet, nprb=small.nprb, nmodes=small.nmodes,
        kernel="pallas")
    psi_n, far_n, prb_n, scan_n = small_np

    def vdot(a, b):
        return np.vdot(a.astype(np.complex128), b.astype(np.complex128))

    lhs = vdot(op.fwd(psi_n, scan_n, prb_n), far_n)
    id_obj = abs(lhs - vdot(psi_n, op.adj(far_n, scan_n, prb_n))) / abs(lhs)
    id_prb = abs(lhs - vdot(prb_n, op.adj_probe(far_n, scan_n, psi_n))) / abs(
        lhs)
    check(id_obj <= 1e-5 and id_prb <= 1e-5, (id_obj, id_prb))
    log("facade", f"small {small}: <G psi, f> = <psi, G^H f> to "
        f"{id_obj:.2e}, = <prb, G_p^H f> to {id_prb:.2e} through "
        "fwd/adj/adj_probe (numpy in, numpy out)")

    # -- 16. options: illum_lowk and parabolic on the hybrid tier -----------
    options = {}
    for label, kw in (("precondition='illum_lowk'",
                       dict(precondition="illum_lowk")),
                      ("linesearch='parabolic'",
                       dict(linesearch="parabolic"))):
        run(data3, psi3, scan3, prb3, g3, piter=2, kernel="pallas", **kw)
        reset_counts()
        t0 = time.perf_counter()
        psi, _, m = run(data3, psi3, scan3, prb3, g3, piter=OPTION_ITERS,
                        kernel="pallas", **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        opt = options[label] = {fn.__name__: fn.launches for fn in counters}
        check(all(fn.launches == 0 for fn in plain), "plain version ran")
        iters = int(m["iters_run"])
        res = m["residual"][:iters].cpu()
        check(bool(torch.isfinite(psi).all())
              and float(res[-1]) < 0.5 * float(res[0]), res)
        check(opt["gather_probe_mul"] >= 2 * iters > 0
              and opt["scatter_conj_probe"] == iters, opt)
        log("options", f"{g3} gaussian, run(kernel='pallas', {label}), "
            f"{iters} iters in {seconds:.3f} s: {iters / seconds:.2f} "
            f"iters/s, {m['evaluations'] / iters:.2f} evals/iter, "
            f"{m['host_syncs'] / iters:.2f} host syncs/iter, residual "
            f"{float(res[0]):.4e} -> {float(res[-1]):.4e}, on {card}")
        del psi, m

    # -- 17. sharded: two gloo ranks share the card -----------------------
    from tikejax_torch.parallel import RankPool

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pool = RankPool(2, device_type="cuda", timeout=900,
                    collective_timeout=600)
    pool.start()
    log("sharded", f"2 gloo ranks on {torch.cuda.get_device_name(0)} (one "
        f"card: NCCL refuses two ranks on one device, gloo takes CUDA "
        f"tensors for all_reduce) up in {time.perf_counter() - t0:.1f} s; "
        "no multi-GPU rate is measured or claimed")

    def one_rank(geom, seed, perturb, kw):
        """The same problem in this process through run: (result, launch
        counts, seconds, checksum)."""
        gs = Geometry(**geom)
        d_, p_, s_, r_ = sharded_problem(torch, gs, seed, dev, perturb)
        run(d_, p_, s_, r_, gs, **dict(kw, piter=2))  # warm-up
        reset_counts()
        t = time.perf_counter()
        out = run(d_, p_, s_, r_, gs, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        check(all(fn.launches == 0 for fn in plain), "plain version ran")
        counts = {fn.__name__: fn.launches for fn in counters}
        return out, counts, t, checksum(torch, d_, s_, r_).cpu()

    def held_to_one_rank(label, ranks, single):
        """Every rank built the problem the one-rank run built, agrees with
        the others bit for bit and made the same collectives; the run
        equals the one-rank run in iterations and evaluations and is within
        SHARDED_TOL of scale in every objective and in psi and prb. Returns
        (iterations, errors)."""
        (psi_1, prb_1, m_1), _, _, sum_1 = single
        for r in ranks:
            check(r["same_problem"] and torch.equal(r["checksum"], sum_1),
                  (label, "the ranks' problems differ"))
            check(r["plain"] == 0, (label, "plain version ran"))
            check(torch.equal(r["psi"], ranks[0]["psi"])
                  and torch.equal(r["prb"], ranks[0]["prb"])
                  and r["collectives"] == ranks[0]["collectives"]
                  and torch.equal(r["metrics"]["minf"],
                                  ranks[0]["metrics"]["minf"]),
                  (label, "the ranks are out of lock step"))
        m = ranks[0]["metrics"]
        n = int(m["iters_run"])
        check(n == int(m_1["iters_run"])
              and m["evaluations"] == m_1["evaluations"],
              (label, "iterations or evaluations differ: a lock-step fault",
               n, int(m_1["iters_run"]), m["evaluations"],
               m_1["evaluations"]))
        f_1 = m_1["minf"][:n].cpu()
        errs = {"minf": float((m["minf"][:n] - f_1).abs().max()
                              / f_1.abs().max()),
                "psi": rel_err(torch, ranks[0]["psi"], psi_1.cpu())[0],
                "prb": rel_err(torch, ranks[0]["prb"], prb_1.cpu())[0]}
        check(all(e <= SHARDED_TOL for e in errs.values()), (label, errs))
        return n, errs

    def show_collectives(r, iters):
        sizes = ", ".join(f"{c} x {b} B" for b, c in sorted(
            r["sizes"].items(), key=lambda kv: -kv[0]))
        return (f"{r['collectives'] / iters:.2f} all-reduces/iter moving "
                f"{r['collective_bytes'] / iters / 2**20:.3f} MiB/iter a "
                f"rank (all {r['collectives']}: {sizes})")

    sharded_counts = {}
    # The joint Poisson search amplifies any difference of rounding: the
    # sharded run sums its objectives over the angles in another order than
    # the one-rank run, so its Poisson theta run is held after
    # THETA_POISSON_ITERS on the hybrid tier ('pallas'); the Gaussian one on
    # the default tier for THETA_ITERS.
    for label, geom, mesh_shape, seed, perturb, kw in (
            ("config5", CONFIG5, 2, SEED + 6, 0.0,
             dict(piter=SHARDED_ITERS)),
            ("theta gaussian", CONFIG3_THETA, (2, 1), SEED + 7, 0.03,
             dict(piter=THETA_ITERS, model="gaussian", recover_prb=True)),
            ("theta poisson", CONFIG3_THETA, (2, 1), SEED + 7, 0.03,
             dict(piter=THETA_POISSON_ITERS, model="poisson",
                  recover_prb=True, kernel="pallas"))):
        t0 = time.perf_counter()
        ranks = pool.run(sharded_job, "run", mesh_shape, geom, seed, kw,
                         perturb)
        job_s = time.perf_counter() - t0
        single = one_rank(geom, seed, perturb, kw)
        n, errs = held_to_one_rank(label, ranks, single)
        counts = {k: sum(r["counts"][k] for r in ranks)
                  for k in ranks[0]["counts"]}
        m = ranks[0]["metrics"]
        mine = ranks[0]["counts"]
        if label == "config5":  # one merged evaluation a call
            check(mine["grad_fused"] == m["evaluations"] * frame_launches(
                fused, *ranks[0]["local"]) > 0, (label, mine))
        elif label == "theta gaussian":  # one probe gradient an iteration
            check(mine["grad_prb_fused"] == n > 0, (label, mine))
        else:  # the hybrid tier's three kernels
            check(mine["gather_probe_mul"] > 0 and mine["adj_probe_reduce"]
                  > 0 and mine["scatter_conj_probe"] > 0
                  and mine["grad_fused"] == 0, (label, mine))
        gs = Geometry(**geom)
        tsh, nsh = mesh_shape if isinstance(mesh_shape, tuple) else (
            1, mesh_shape)
        sharded_counts[label] = (counts, (gs.ntheta // tsh, gs.nscan // nsh,
                                          gs.nmodes, gs.nprb))
        busy = [r["busy"][0] * r["busy"][1] / PROFILE_ITERS for r in ranks]
        log("sharded", f"{label} {gs} on a {mesh_shape} mesh, "
            f"{kw}: {n} iters in {ranks[0]['seconds']:.3f} s "
            f"({1e3 * ranks[0]['seconds'] / n:.2f} ms/iter; one rank "
            f"{1e3 * single[2] / n:.2f} ms/iter), "
            f"{m['evaluations']} evaluations as one rank's "
            f"{single[0][2]['evaluations']}, objectives within "
            f"{errs['minf']:.2e}, psi {errs['psi']:.2e}, prb "
            f"{errs['prb']:.2e} of scale (limit {SHARDED_TOL:g}); "
            "the ranks bitwise equal; " + show_collectives(ranks[0], n)
            + f"; card busy per rank {', '.join(f'{b:.2f}' for b in busy)} "
            f"ms/iter under torch.profiler ({PROFILE_ITERS} iterations); "
            f"launches over both ranks {counts}; job {job_s:.1f} s "
            f"with the problem's making, on {card}")
        del ranks, single
        torch.cuda.empty_cache()
    # reconstruct(mesh=) to 1e-6 on the headline.
    t0 = time.perf_counter()
    ranks = pool.run(sharded_job, "deep", 2, HEADLINE, SEED + 8,
                     dict(target_residual=DEEP_TARGET,
                          max_segments=DEEP_MAX_SEGMENTS))
    job_s = time.perf_counter() - t0
    pool.close()
    r0 = ranks[0]
    check(all(r["same_problem"] and r["plain"] == 0 for r in ranks)
          and all(r["stages"] == r0["stages"]
                  and torch.equal(r["psi"], r0["psi"])
                  and r["collectives"] == r0["collectives"] for r in ranks),
          "sharded deep: the ranks disagree")
    d_iters = sum(k for _, k, _, _ in r0["stages"])
    d_res = r0["stages"][-1][3]
    n_split = sum(1 for name, _, _, _ in r0["stages"]
                  if name.startswith("split:"))
    check(d_res <= DEEP_TARGET, ("sharded deep", d_res, r0["stages"]))
    check(bool(torch.isfinite(r0["psi"]).all()), "sharded deep psi")
    check(r0["counts"]["grad_fused"] == sum(e for _, _, e, _ in r0["stages"])
          * frame_launches(fused, *r0["local"])
          and r0["counts"]["fwd"] == 2 * n_split, r0["counts"])
    d_counts = {k: sum(r["counts"][k] for r in ranks) for k in r0["counts"]}
    sharded_counts["deep"] = (d_counts, (g.ntheta, g.nscan // 2, g.nmodes,
                                         g.nprb))
    log("sharded", f"deep {g} reconstruct(mesh=('scan', 2), "
        f"target_residual={DEEP_TARGET:g}): {r0['seconds']:.3f} s, "
        f"{d_iters} iters in {len(r0['stages'])} stages "
        f"{[f'{n}:{k}' for n, k, _, _ in r0['stages']]}, final residual "
        f"{d_res:.4e}; one rank (phase deep, another problem of the same "
        f"size): {deep_summary[0]:.3f} s, {deep_summary[1]} iters in "
        f"{deep_summary[2]} stages; "
        + show_collectives(r0, d_iters)
        + f"; launches over both ranks {d_counts}; job {job_s:.1f} s, on "
        f"{card}")
    del ranks, r0

    # -- 18. tiled: object tiling (P3), the ranks sharing the card ---------
    # Each rank holds its slab (owned rows and the nprb - 1 halo rows below)
    # and the positions whose window's top row it owns, padded with
    # sentinels to the fullest slab's count; every object gradient and the
    # illumination map go through the halo exchange (broadcasts in the pair
    # groups {d, d + 1}). Held to the one-rank run like phase 17's.
    tiled_counts = {}
    for label, geom, mesh_shape, seed, perturb, kw in (
            ("headline", HEADLINE, (2,), SEED + 9, 0.0,
             dict(piter=TILED_ITERS)),
            ("config3 joint", CONFIG3, (2, 2), SEED + 10, 0.03,
             dict(piter=TILED_ITERS, model="gaussian", recover_prb=True))):
        t0 = time.perf_counter()
        tpool = RankPool(math.prod(mesh_shape), device_type="cuda",
                         timeout=900, collective_timeout=600)
        try:
            tpool.start()
            up_s = time.perf_counter() - t0
            ranks = tpool.run(tiled_job, mesh_shape, geom, seed, kw, perturb)
        finally:
            tpool.close()
        job_s = time.perf_counter() - t0
        single = one_rank(geom, seed, perturb, kw)
        n, errs = held_to_one_rank(label, ranks, single)
        gs = Geometry(**geom)
        m = ranks[0]["metrics"]
        mine = ranks[0]["counts"]
        if label == "headline":  # the merged body: one grad_fused a call
            check(mine["grad_fused"] == m["evaluations"] * frame_launches(
                fused, *ranks[0]["local"]) > 0, (label, mine))
        else:  # one probe gradient an iteration
            check(mine["grad_prb_fused"] == n > 0, (label, mine))
        # Every rank exchanges the same strips: two broadcasts of a
        # (t, nprb - 1, n) strip a pair group it is in, an exchange.
        strip = gs.ntheta * (gs.nprb - 1) * gs.n * 8
        check(all(r["halo"] > 0 and r["halo_bytes"] % (strip // 2) == 0
                  for r in ranks), (label, [r["halo"] for r in ranks]))
        counts = {k: sum(r["counts"][k] for r in ranks)
                  for k in ranks[0]["counts"]}
        tiled_counts[label] = (counts, ranks[0]["local"])
        log("tiled", f"{label} {gs} on a {mesh_shape} "
            f"{('obj',) if len(mesh_shape) == 1 else ('obj', 'scan')} mesh "
            f"of {len(ranks)} gloo ranks sharing the card (up in "
            f"{up_s:.1f} s), {kw}: {n} iters in {ranks[0]['seconds']:.3f} s "
            f"({1e3 * ranks[0]['seconds'] / n:.2f} ms/iter; one rank "
            f"{1e3 * single[2] / n:.2f} ms/iter), {m['evaluations']} "
            f"evaluations as one rank's {single[0][2]['evaluations']}, "
            f"objectives within {errs['minf']:.2e}, psi {errs['psi']:.2e}, "
            f"prb {errs['prb']:.2e} of scale (limit {SHARDED_TOL:g}); the "
            "ranks bitwise equal; halo broadcasts/iter a rank "
            + ", ".join(f"{r['halo'] / n:.2f} ({r['halo_bytes'] / n:.0f} B)"
                        for r in ranks)
            + f" (a gradient strip {strip} B); "
            + show_collectives(ranks[0], n)
            + "; real / padded positions a rank " + ", ".join(
                f"{r['positions'][0]} / {r['positions'][1]}" for r in ranks)
            + f"; launches over the ranks {counts}; job {job_s:.1f} s with "
            f"the ranks' start and the problem's making, on {card}")
        del ranks, single
        torch.cuda.empty_cache()

    # -- 19. large: objects past the headline's 512^2, whole ---------------
    large_counts, large_times, large_turns = large_phase(
        torch, dev, card, timer, reset_counts, counters, plain)
    for times, _ in large_times.values():
        for name, (abs_err, _, _) in times.items():
            results[name] = ((max(results[name][0], abs_err),)
                             + results[name][1:])

    # Launches of each kernel on each phase, with the frames (positions
    # times modes) of one launch there: the times above are at the headline
    # frame size (16384 frames), and a phase's share is launches x time
    # scaled by its frames. A phase is given by the counts and the shape
    # (angles, positions, modes, probe side) of one call; adj launches its
    # frame kernel once per chunk of positions (fused.adj_chunk), grad_fused
    # and adj_residual once per chunk of frames (fused.frame_chunk), and the
    # tile scatter takes the chunks of the kernel that launches it.
    def launch_frames(name, counts, t, s, m, p):
        if name == "scatter_conj_probe":
            name = next((k for k in ("grad_fused", "adj_residual", "adj")
                         if counts[k]), name)
        if name == "adj":
            return t * m * fused.adj_chunk(t, s, m, p)
        if name in ("grad_fused", "adj_residual"):
            return m * min(fused.frame_chunk(m, p), t * s)
        return t * m * s

    phases = {
        "main": (main_counts, shape(g)),
        "deep": (deep, shape(g)),
        "materialized": (mat, shape(g)),
        "fused-ls": (fls, shape(g)),
        "hybrid": (hyb, shape(g)),
        "frameless": (frameless, shape(g4)),
        "joint": (joint, shape(g3)),
        "joint-materialized": (matj, shape(g3)),
        "stream": (stream, shape(g3, g3.nscan // STREAM_CHUNKS)),
        "joint-deep": (jdeep, shape(g3)),
        "facade": (fac, shape(g3)),
        **{f"options {k}": (v, shape(g3)) for k, v in options.items()},
        # Over both ranks; the shape of one rank's call.
        **{f"sharded {k}": v for k, v in sharded_counts.items()},
        # Over the ranks; the shape of one rank's call.
        **{f"tiled {k}": v for k, v in tiled_counts.items()},
        **large_counts,
    }
    # lbfgs.cu's two wrappers are reported each on its own; they take no
    # frames.
    reported = {**{k: v for k, v in KERNEL_SOURCES.items() if k != "lbfgs"},
                **{k: KERNEL_SOURCES["lbfgs"] for k in LBFGS_WRAPPERS}}
    by_path = {name: {phase: {"launches": counts[name],
                              "frames": (None if name in LBFGS_WRAPPERS else
                                         launch_frames(name, counts, *dims))}
                      for phase, (counts, dims) in phases.items()
                      if counts[name]}
               for name in reported}
    check(all(by_path.values()), ("a kernel ran on no path", by_path))
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": sum(v["launches"] for v in by_path[name].values()),
        "launches_by_path": by_path[name],
        "frames_of_ms": (None if name in LBFGS_WRAPPERS
                         else g.ntheta * g.nscan * g.nmodes),
        "max_abs_err": results[name][0], "ms": results[name][1],
        "plain_ms": results[name][2], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": None,
        **({"variant": "fft", "gemm_ms": variant_lines[name]}
           if name in variant_lines else {}),
        **({"variant": "tile", "atomic_ms": scatter_atomic_ms,
            "skip_in_turns_ms": {k: {"skip": new, "every_chunk": old}
                                 for k, (new, old) in large_turns.items()}}
           if name == "scatter_conj_probe" else {}),
        **({"large": {k: {"ms": times[name][1], "bound_ms": times[name][2][0],
                          "bound_by": times[name][2][1],
                          **(extra if name == "scatter_conj_probe" else {})}
                      for k, (times, extra) in large_times.items()}}
           if name in ("grad_fused", "minf_fused", "fwd",
                       "scatter_conj_probe") else {}),
        **({"atomic_ms": adj_atomic_ms} if name == "adj" else {}),
        **({"body": "fft_regs", "fft_smem_ms": body_turns["no base"][1],
            "bodies_in_turns_ms": body_turns}
           if name == "grad_fused" else {}),
        **({"body": "fft_regs",
            "fft_smem_ms": minf_turns[f"{g.nscan} frames, no base"][1],
            "bodies_in_turns_ms": minf_turns}
           if name == "minf_fused" else {}),
        **({"atomic_ms": scan_order_atomic_ms[name]}
           if name in scan_order_atomic_ms else {}),
        **({"compact_plain_ms": {k: v[0] for k, v in lb_compact[name].items()}}
           if name in LBFGS_WRAPPERS else {})}
        for name, (src, tpu) in reported.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
