"""Share of its bound that the Fakhari kernel family (csrc/fakhari_step.cu:
the collide-and-stream, phi and velocity kernels, and the phi pass that
opens each call) reaches: counted bytes a step (work/fakhari_step.json)
over the data-sheet memory rate, over the device time a step of the
kernels launched inside the span around the stepping entry."""
from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "fakhari_step")
