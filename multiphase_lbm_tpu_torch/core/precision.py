"""Full-float32 contractions for the plain (oracle) paths.

The counterpart of ``multiphase_lbm_tpu/core/precision.py``, which pins
``precision=HIGHEST`` on every einsum because a TPU would otherwise run
float32 contractions in bf16.  On an NVIDIA card the same hazard is TF32:
cuBLAS and cuDNN may round float32 inputs to a 10-bit mantissa.  The plain
paths are the oracles the CUDA kernels are held against, so they must keep
every float32 bit; :func:`pin_float32_matmul` runs once at package import.
"""
import torch


def pin_float32_matmul():
    """Turn TF32 off for matmuls and convolutions (full float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
