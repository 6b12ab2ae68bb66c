"""kernel.frame_pass.roofline.modes4: the frame kernel of the object
gradient's chunks (the span ``fused.frame_pass``) at its least time over
the card's time in it, in %, from the program's span report of the
profiled cycle (``h100bench.frame_spans``). Its work: two 2-D FFTs of
every (angle, position, mode) frame it took; each position's measured
frame read once, each frame's crop written once, and the object and probe
read once a launch."""

from h100bench import frame_spans


def read(run):
    g = run.geometry
    obj, prb = frame_spans.problem_bytes(run)

    def moved(frames, launches):
        return (frames // g.nmodes * g.ndet * g.ndet * 4
                + frames * g.nprb * g.nprb * 8 + launches * (obj + prb))

    return frame_spans.share(run, "fused.frame_pass", 2, moved)
