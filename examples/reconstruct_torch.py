"""End-to-end reconstruction demo on the PyTorch/CUDA port: simulate,
reconstruct, report.

Usage:
  python examples/reconstruct_torch.py [--size 256] [--nscan 1024]
      [--piter 64] [--model gaussian|poisson] [--recover-prb] [--nmodes 1]
      [--checkpoint out.npz] [--device cuda|cpu]
  python examples/reconstruct_torch.py --target 1e-6   # deep-residual driver
      (solvers.reconstruct: kernel tiering + split-operator refinement
      + Anderson mixing; --piter is ignored in this mode)

The port's counterpart of ``examples/reconstruct.py`` (same arguments, plus
``--device``): the problem is made on the device from a fixed seed, the
solvers run there (the card by default, through the port's CUDA kernels;
``--device cpu`` runs their plain PyTorch versions), and the times are taken
between two synchronises.
"""

import argparse
import time

import torch

from tikejax_torch import Geometry
from tikejax_torch.models import make_problem
from tikejax_torch.solvers import reconstruct, run
from tikejax_torch.utils import Timer, checkpoint, summarize_metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--nscan", type=int, default=1024)
    ap.add_argument("--ndet", type=int, default=64)
    ap.add_argument("--nprb", type=int, default=64)
    ap.add_argument("--nmodes", type=int, default=1)
    ap.add_argument("--piter", type=int, default=64)
    ap.add_argument("--model", default="gaussian",
                    choices=["gaussian", "poisson"])
    ap.add_argument("--recover-prb", action="store_true")
    ap.add_argument("--nchunks", type=int, default=1)
    ap.add_argument("--photons", type=float, default=None,
                    help="add Poisson shot noise at this photon budget")
    ap.add_argument("--target", type=float, default=None,
                    help="reconstruct to this relative residual via the "
                         "deep-residual driver instead of a fixed piter")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device the problem and the solvers run on "
                         "(default: the card)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    g = Geometry(nz=args.size, n=args.size, nscan=args.nscan, ndet=args.ndet,
                 nprb=args.nprb, nmodes=args.nmodes)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}; geometry: {g}")

    gen = torch.Generator(device=dev).manual_seed(0)
    psi_true, scan, prb, data = make_problem(
        gen, g, poisson_photons=args.photons, device=dev)
    psi0 = torch.ones(g.psi_shape, dtype=psi_true.dtype, device=dev)
    timer = Timer()

    if args.target is not None:
        with timer("reconstruct"):
            psi, prb_out, stages = reconstruct(
                data, psi0, scan, prb, g, target_residual=args.target,
                model=args.model, recover_prb=args.recover_prb,
                nchunks=args.nchunks)
        ran = 0
        for stage, m in stages:
            k = max(int(m["iters_run"]), 1)
            print(f"  stage {stage:>14s}: {k:4d} iters, residual "
                  f"{float(m['residual'][k - 1]):.3e}")
            ran += k
            metrics = m
        print(f"{ran} iters / {len(stages)} stages in "
              f"{timer.times['reconstruct']:.2f}s")
    else:
        with timer("run"):
            psi, prb_out, metrics = run(
                data, psi0, scan, prb, g, piter=args.piter, model=args.model,
                recover_prb=args.recover_prb, nchunks=args.nchunks)
        # stop_on_stall / target_residual may exit early: the table stops
        # at the executed iteration count.
        ran = max(int(metrics["iters_run"]), 1)
        dt = timer.times["run"]
        print(f"{ran} iters in {dt:.2f}s ({ran / dt:.1f} iters/s)")
        shown = {k: metrics[k][:ran] for k in ("minf", "gamma", "grad_norm")}
        print(summarize_metrics(shown, every=max(1, ran // 8)))

    # Phase-aligned relative error against the ground truth (interior).
    m = g.n // 8
    a = psi[..., m:-m, m:-m].reshape(-1)
    b = psi_true[..., m:-m, m:-m].reshape(-1)
    phase = torch.vdot(a, b)
    phase = phase / phase.abs()
    err = float(torch.linalg.vector_norm(a * phase - b)
                / torch.linalg.vector_norm(b))
    print(f"  object rel err vs truth (interior, phase-aligned): {err:.4f}")

    if args.checkpoint:
        checkpoint.save(args.checkpoint,
                        {"psi": psi, "prb": prb_out, "metrics": metrics})
        print(f"saved state to {args.checkpoint}")
    return err


if __name__ == "__main__":
    main()
