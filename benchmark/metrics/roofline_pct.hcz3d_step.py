"""Share of its bound that the HCZ 3D kernel family (csrc/hcz3d_step.cu:
the phi pass and the z-marching tile) reaches: counted bytes a step
(work/hcz3d_step.json) over the data-sheet memory rate, over the device
time a step of the kernels launched inside the span around the stepping
entry."""
from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "hcz3d_step")
