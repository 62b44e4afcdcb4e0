"""Lattice descriptors (velocity sets, weights, opposite maps).

A copy of ``multiphase_lbm_tpu/core/lattice.py``: the tables are plain
numpy constants, but importing them from the JAX package would import jax
(its ``__init__`` pulls in the jax-based core modules).
``tests/test_torch_core.py`` holds every table here equal to the JAX one.

Populations are stored as dense tensors ``f[Q, ny, nx]`` (2D) /
``f[Q, nz, ny, nx]`` (3D) with the x axis last.

Orderings reproduced from the reference for output/validation parity:

* D2Q9 "module" ordering (rest at k=4, opposite-paired halves), used by every
  app module: reference ``Abbashub LBM/apps/PulsatileBloodFlow2D.h:29-38``,
  ``shan-chen single component model/apps/laplace2D.h:29-41``.
* D2Q9 "Abbas I" ordering (0=rest, 1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE)
  used by the Zou/He + Bouzidi boundary code of the pulsatile module:
  reference ``PulsatileBloodFlow2D.h:40-48``.
* D3Q19 ordering of the phase-field 3D module: reference
  ``Phase field model/apps/laplace3D.h:31-55``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Static velocity-set descriptor.

    Attributes:
      name: human-readable name.
      d: spatial dimension (2 or 3).
      q: number of discrete velocities.
      c: int array ``(q, d)`` of velocities, components ordered ``(cx, cy[, cz])``.
      w: float array ``(q,)`` of quadrature weights.
      opp: int array ``(q,)`` with ``c[opp[k]] == -c[k]``.
    """

    name: str
    d: int
    q: int
    c: np.ndarray
    w: np.ndarray
    opp: np.ndarray

    def __post_init__(self):
        assert self.c.shape == (self.q, self.d)
        assert self.w.shape == (self.q,)
        np.testing.assert_array_equal(self.c[self.opp], -self.c)
        np.testing.assert_allclose(self.w.sum(), 1.0, rtol=1e-12)

    # identity by name: each named descriptor is a module-level constant
    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Lattice) and other.name == self.name

    @property
    def cs2(self) -> float:
        return 1.0 / 3.0

    def roll_shifts(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-direction pull-stream roll shifts for tensors laid out
        ``(..., y, x)`` (2D) or ``(..., z, y, x)`` (3D).

        Pull streaming reads the population arriving at a cell from the
        upstream cell ``r - c_k``; with ``torch.roll`` semantics
        (``out[i] = a[i - s]``, the same rule as ``jnp.roll``) that is a
        roll by ``+c_k`` on each axis, with the component order reversed to
        match the (…, z, y, x) layout.
        """
        return tuple(tuple(int(s) for s in ck[::-1]) for ck in self.c)


def _make(name, d, c_list, w_list) -> Lattice:
    c = np.asarray(c_list, dtype=np.int32)
    w = np.asarray(w_list, dtype=np.float64)
    q = c.shape[0]
    opp = np.empty(q, dtype=np.int32)
    for k in range(q):
        matches = np.where((c == -c[k]).all(axis=1))[0]
        assert len(matches) == 1
        opp[k] = matches[0]
    return Lattice(name=name, d=d, q=q, c=c, w=w, opp=opp)


# ─── D2Q9 module ordering (rest at k=4), c rows are (cx, cy) ───────────────
# Matches d2q9_constants_* of every reference app module, e.g.
# laplace2D.h:29-41.  opp == {5, 6, 7, 8, 4, 0, 1, 2, 3}.
D2Q9 = _make(
    "D2Q9",
    2,
    [(-1, 0), (0, -1), (-1, -1), (-1, 1), (0, 0),
     (1, 0), (0, 1), (1, 1), (1, -1)],
    [1 / 9, 1 / 9, 1 / 36, 1 / 36, 4 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36],
)
assert list(D2Q9.opp) == [5, 6, 7, 8, 4, 0, 1, 2, 3]

# ─── D2Q9 "Abbas I" ordering used by the pulsatile BC code ─────────────────
# I: 0=rest, 1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE
# (reference PulsatileBloodFlow2D.h:40-48)
EX_I = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
EY_I = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)
JB_I = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)   # opposite in I-space
K_FROM_I = np.array([4, 5, 6, 0, 1, 7, 3, 2, 8], dtype=np.int32)
# sanity: module-order c at K_FROM_I equals the I-space velocity
np.testing.assert_array_equal(D2Q9.c[K_FROM_I, 0], EX_I)
np.testing.assert_array_equal(D2Q9.c[K_FROM_I, 1], EY_I)

# ─── D3Q19 (phase-field 3D module ordering), c rows are (cx, cy, cz) ───────
# Matches d3q19_constants of reference laplace3D.h:31-55: nine "negative-half"
# directions first, rest at k=9, then the nine positive mirrors.
D3Q19 = _make(
    "D3Q19",
    3,
    [(-1, 0, 0), (0, -1, 0), (0, 0, -1),
     (-1, -1, 0), (-1, 1, 0), (-1, 0, -1),
     (-1, 0, 1), (0, -1, -1), (0, -1, 1),
     (0, 0, 0),
     (1, 0, 0), (0, 1, 0), (0, 0, 1),
     (1, 1, 0), (1, -1, 0), (1, 0, 1),
     (1, 0, -1), (0, 1, 1), (0, 1, -1)],
    [1 / 18, 1 / 18, 1 / 18,
     1 / 36, 1 / 36, 1 / 36,
     1 / 36, 1 / 36, 1 / 36,
     1 / 3,
     1 / 18, 1 / 18, 1 / 18,
     1 / 36, 1 / 36, 1 / 36,
     1 / 36, 1 / 36, 1 / 36],
)

# ─── D2Q9 combustion ordering (rest first), reference CooLBM_MRT_combustion.cpp:302-316
D2Q9_REST_FIRST = _make(
    "D2Q9_rest_first",
    2,
    [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
     (1, 1), (-1, 1), (-1, -1), (1, -1)],
    [4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 36, 1 / 36],
)
