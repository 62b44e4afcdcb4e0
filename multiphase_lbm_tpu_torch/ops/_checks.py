"""What every kernel wrapper checks of its input before it runs.

:func:`on_card` is the device rule of the public entries (``ops/*_fused.py``):
a CUDA tensor runs the hand-written kernel, a CPU tensor the plain path,
and any other device raises.  :func:`check_tensors` and :func:`check_mask`
hold the state and the fluid mask to what the C entries read: contiguous
tensors of the shapes, dtype and device the kernel is given, checked before
a pointer reaches it.  The rules of one family (a channel's row count, the
combustion tables) stay in its wrapper.
"""
from __future__ import annotations

import torch

FLOATS = (torch.float32, torch.float64)


class MismatchError(TypeError, ValueError):
    """A tensor of another dtype than the first of its state: a
    ``TypeError``, and a ``ValueError`` as the HCZ and Fakhari entries
    have raised it."""


def on_card(t: torch.Tensor, n_steps: int | None = None) -> bool:
    """Whether ``t`` runs the kernel: True on a CUDA device, False on the
    CPU (the plain path); raises ``ValueError`` on any other device, and
    for ``n_steps < 0`` where the entry takes steps."""
    if n_steps is not None and n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def check_tensors(*named):
    """Raise unless every ``(name, tensor, shape)`` of ``named`` is a
    contiguous float32 or float64 tensor of ``shape``, of the first one's
    dtype and on its device.  ``(q, None, …, None)`` is a shape of ``q``
    populations over a lattice: any lattice in the first tensor, the first
    tensor's in the others.

    ``TypeError`` for a tensor that is none or not of a float dtype, or not
    of the first one's (:class:`MismatchError`); ``ValueError`` for a shape,
    a device or a layout."""
    first = None
    for name, t, shape in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        dtype = t.dtype
        if dtype not in FLOATS:
            raise TypeError(f"{name} must be float32 or float64, got {dtype}")
        got = t.shape
        if shape[-1] is not None:
            ok = got == shape
        else:
            ok = len(got) == len(shape) and got[0] == shape[0] and (
                first is None or got[1:] == first.shape[1:])
            if first is not None:
                shape = (shape[0], *first.shape[1:])
        if not ok:
            raise ValueError(f"{name} must have shape "
                             f"{tuple('*' if n is None else n for n in shape)}"
                             f", got {tuple(got)}")
        if first is None:
            first, first_name = t, name
        elif dtype != first.dtype:
            raise MismatchError(f"{name} {dtype} does not match "
                                f"{first_name} {first.dtype}")
        elif t.device != first.device:
            raise ValueError(f"{name} on {t.device} does not match "
                             f"{first_name} on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_mask(mask, like: torch.Tensor, name: str = "fluid_f32",
               dtype=torch.float32):
    """Raise unless ``mask`` is a contiguous ``dtype`` tensor of ``like``'s
    lattice (its shape past the first axis) on ``like``'s device:
    ``TypeError`` for the type or dtype, ``ValueError`` else."""
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"{name} must be a torch tensor")
    if mask.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {mask.dtype}")
    if mask.shape != like.shape[1:]:
        raise ValueError(f"{name} shape {tuple(mask.shape)} does not match "
                         f"the lattice {tuple(like.shape[1:])}")
    if mask.device != like.device:
        raise ValueError(f"{name} on {mask.device} does not match the "
                         f"lattice on {like.device}")
    if not mask.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
