"""Share of its bound that the SC-RT kernel family (csrc/scrt_step.cu: the
psi pass and the collide-and-stream pass of each step) reaches: counted
bytes a step (work/scrt_step.json) over the data-sheet memory rate, over
the device time a step of the kernels launched inside the span around the
stepping entry."""
from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "scrt_step")
