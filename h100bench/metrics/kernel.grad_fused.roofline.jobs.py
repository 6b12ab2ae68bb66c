"""kernel.grad_fused.roofline.jobs: the object gradient operator
``ops.fused.grad_fused``'s least time over its time on the cell's own
inputs, in % (``roofline.gradient_share``)."""

from h100bench import roofline


def read(run):
    return roofline.gradient_share(run, "grad_fused", "psi")
