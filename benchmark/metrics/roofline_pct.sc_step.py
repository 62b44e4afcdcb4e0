"""Share of its bound that the Shan–Chen kernel family (csrc/sc_step.cu)
reaches: counted bytes a step (work/sc_step.json) over the data-sheet
memory rate, over the device time a step of the kernels launched inside
the span around the stepping entry."""
from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "sc_step")
