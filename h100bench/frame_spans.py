"""The two stages of the object gradient's chunks in the program's span
report: the frame kernel (span ``fused.frame_pass``) and the tile scatter
(span ``fused.tile_scatter``) of ``tikejax_torch.ops.fused``'s scan-order
path, each with its least time over the card's time in its kernels.

The work comes from the report and the geometry alone: each span is one
chunk of the pass over the (angle, position, mode) frames, which the
program cuts into ``len(frame_chunks(t, s, frame_chunk(m, nprb)))``
chunks, so the spans' count gives the passes and the passes the frames.
Its least time is ``h100bench.roofline``'s: two 2-D FFTs of every frame
counted at the float32 peak; each input read once and each output written
once at the memory peak. None off the card, outside a traced run, or where
the program has no such spans.
"""

from __future__ import annotations

from h100bench import roofline, spans


def frames(run, count: int):
    """The (angle, position, mode) frames that ``count`` chunk spans took
    on the cell's geometry; None where the count is not whole passes."""
    g, fused = run.geometry, run.program.fused
    per_pass = g.ntheta * g.nscan * g.nmodes
    chunks = len(fused.frame_chunks(g.ntheta, g.nscan,
                                    fused.frame_chunk(g.nmodes, g.nprb)))
    if count % chunks:
        run.note(f"{count} chunk spans are not whole passes of {chunks}")
        return None
    return count // chunks * per_pass


def share(run, span: str, fft_dfts: int, moved):
    """100 x the least time of the span's work over the card's time in
    the kernels launched inside it, in %: ``fft_dfts`` 2-D FFTs of every
    frame the spans took, and ``moved(frames, launches)`` bytes for that
    many (angle, position, mode) frames over that many spans. None where
    there is nothing to read."""
    rep = spans.report(run)
    if rep is None or span not in rep.by_name:
        return None
    f = rep.by_name[span]
    work = frames(run, f.count)
    if not work or not f.device_s:
        return None
    g = run.geometry
    least, by = roofline.bound(roofline.fft_flops(work, 1, g.ndet, fft_dfts),
                               moved(work, f.count))
    run.note(f"{span}: {f.count} spans, {work} frames x modes, "
             f"{f.device_s!r} s on the card, least {least!r} ms (by {by})")
    return 100.0 * least / (1e3 * f.device_s)


def problem_bytes(run) -> tuple[int, int]:
    """(the object's bytes, the probe's bytes) of the pool's first
    problem, complex64 as the program holds them."""
    p = run.problems[0]
    return roofline.nbytes(p.psi0), roofline.nbytes(p.prb0)
