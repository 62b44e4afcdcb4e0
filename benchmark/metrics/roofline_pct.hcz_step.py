"""Share of its bound that the HCZ 2D kernel family (csrc/hcz_step.cu)
reaches: counted bytes a step (work/hcz_step.json) over the data-sheet
memory rate, over the device time a step of the kernels launched inside
the span around the stepping entry."""
from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "hcz_step")
