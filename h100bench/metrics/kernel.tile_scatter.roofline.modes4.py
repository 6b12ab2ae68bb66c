"""kernel.tile_scatter.roofline.modes4: the tile scatter of the object
gradient's chunks (the span ``fused.tile_scatter``) at its least time over
the card's time in it, in %, from the program's span report of the
profiled cycle (``h100bench.frame_spans``). Its work: each (angle,
position, mode) frame's crop read once (8 B a pixel), and the probe read
and the object written once a chunk; no FFT."""

from h100bench import frame_spans


def read(run):
    g = run.geometry
    obj, prb = frame_spans.problem_bytes(run)

    def moved(frames, launches):
        return frames * g.nprb * g.nprb * 8 + launches * (obj + prb)

    return frame_spans.share(run, "fused.tile_scatter", 0, moved)
