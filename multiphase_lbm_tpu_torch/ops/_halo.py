"""What the halo-in entries of the kernel wrappers share.

A halo-in entry (``step_fused_halo`` of a wrapper) takes a slab whose
``halo`` cells on either side of the cut axis its neighbours have already
filled, runs ``nsub`` steps of its family on the whole slab and returns the
interior.  A step of a family reads at most ``reach`` cells away (its
stencil reach plus streaming), so after ``nsub`` steps only the outer
``reach · nsub`` cells on each side can differ from the global run: the
wrap of the kernel's (or the plain step's) index arithmetic at the slab's
edge never reaches the interior when ``halo >= reach · nsub``.
"""
from __future__ import annotations


def check(halo, reach: int, nsub: int, extent: int, what: str) -> int:
    """The halo width to use (``reach · nsub`` when ``halo`` is None);
    raises unless ``nsub >= 1``, ``halo >= reach · nsub`` and the slab's
    ``extent`` along the cut axis leaves an interior."""
    if nsub < 1:
        raise ValueError(f"nsub must be >= 1, got {nsub}")
    if halo is None:
        halo = reach * nsub
    if halo < reach * nsub:
        raise ValueError(f"halo {halo} {what} < reach·nsub = {reach}·{nsub}: "
                         "the interior would read cells the neighbours did "
                         "not fill")
    if extent - 2 * halo < 1:
        raise ValueError(f"a slab of {extent} {what} has no interior inside "
                         f"a halo of {halo}")
    return halo


def interior(t, halo: int, dim: int):
    """``t`` without its ``halo`` cells on either side of ``dim``, as a new
    contiguous tensor."""
    return t.narrow(dim, halo, t.shape[dim] - 2 * halo).contiguous()
