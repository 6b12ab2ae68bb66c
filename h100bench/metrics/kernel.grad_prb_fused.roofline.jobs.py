"""kernel.grad_prb_fused.roofline.jobs: the probe gradient operator
``ops.fused.grad_prb_fused``'s least time over its time on the cell's own
inputs, in %, in cells that recover the probe
(``roofline.gradient_share``)."""

from h100bench import roofline


def read(run):
    return roofline.gradient_share(run, "grad_prb_fused", "prb")
