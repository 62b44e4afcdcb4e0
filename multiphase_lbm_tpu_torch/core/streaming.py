"""Streaming operators (pure gather formulations).

Port of ``multiphase_lbm_tpu/core/streaming.py``.  The population arriving
at cell ``r`` in direction ``k`` is read from the upstream cell ``r - c_k``
with ``torch.roll``, whose rule ``out[i] = a[i - s]`` is that of
``jnp.roll``.  Push-with-on-site-bounce-back (reference
``laplace2D.h:260-270``) is algebraically this pull rule:

    f_new(j, k) = post(j - c_k, k)   if fluid(j - c_k)
                  post(j, opp[k])    otherwise  (half-way bounce-back)

Solid cells keep zero populations, exactly like the reference which zeroes
them at init and never writes them.  Tensors are laid out ``(Q, y, x)`` in
2D and ``(Q, z, y, x)`` in 3D; rolls wrap periodically on every axis.
"""
from __future__ import annotations

import torch

from .lattice import Lattice


def _spatial_dims(lattice: Lattice):
    return tuple(range(lattice.d))


def stream_periodic(post, lattice: Lattice):
    """Pull streaming on a fully periodic domain.

    Args:
      post: post-collision populations ``(Q, [z,] y, x)``.
      lattice: velocity-set descriptor.
    Returns:
      streamed populations, same shape.
    """
    shifts = lattice.roll_shifts()
    dims = _spatial_dims(lattice)
    return torch.stack(
        [torch.roll(post[k], shifts[k], dims=dims) for k in range(lattice.q)],
        dim=0,
    )


def stream_bounce_back(post, fluid, lattice: Lattice):
    """Pull streaming with half-way (on-site) bounce-back at solid cells.

    Args:
      post: post-collision populations ``(Q, [z,] y, x)``.
      fluid: bool mask ``([z,] y, x)``, True where the cell is fluid.
      lattice: descriptor.
    Returns:
      new populations; zero at solid cells.
    """
    shifts = lattice.roll_shifts()
    opp = lattice.opp
    dims = _spatial_dims(lattice)
    out = []
    for k in range(lattice.q):
        pulled = torch.roll(post[k], shifts[k], dims=dims)
        upstream_fluid = torch.roll(fluid, shifts[k], dims=dims)
        out.append(torch.where(upstream_fluid, pulled, post[int(opp[k])]))
    f_new = torch.stack(out, dim=0)
    return f_new * fluid[None].to(post.dtype)
