"""The faults the self-test plants under a rehearsal, each a wrapper of the
function it breaks: three of the stepping entry (a step that returns its
state unchanged, one that advances only half the rows, one population
altered where the step produces it) and one of the diagnostics a
configuration lists under ``diagnostics`` (the mean taken over half the
lattice).  None of them names a configuration: the stepping entry and the
diagnostics are found through the configuration's file.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.hooks import resolve


def stale(orig):
    """A step that returns its state unchanged."""
    def run_fused(*args, **kw):
        out = orig(*args, **kw)
        return tuple(a.clone() for a in args[:len(out)]) if isinstance(out, tuple) \
            else args[0].clone()
    return run_fused


def half(orig):
    """A step that advances only the lower half of the lattice's rows."""
    def run_fused(*args, **kw):
        out = orig(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        res = []
        for new, old in zip(outs, args):
            mixed = new.clone()
            mixed[:, new.shape[1] // 2:] = old[:, new.shape[1] // 2:]
            res.append(mixed)
        return tuple(res) if isinstance(out, tuple) else res[0]
    return run_fused


def altered(orig):
    """One population of one cell altered where the step produces it."""
    def run_fused(*args, **kw):
        out = orig(*args, **kw)
        outs = tuple(t.clone() for t in (out if isinstance(out, tuple) else (out,)))
        outs[0][4, 1, 1] *= 1.1
        return outs if isinstance(out, tuple) else outs[0]
    return run_fused


STEP_FAULTS = {"stale": stale, "half": half, "altered": altered}


def _first_tensor(x):
    """The first tensor in ``x``, depth first through tuples and dicts;
    None where it holds none."""
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x if isinstance(x, tuple) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _cut(x, lattice):
    """``x`` with every tensor or array whose trailing axes are
    ``lattice`` cut to the first half of the first of those axes, through
    tuples, named tuples and dicts; what holds none is ``x`` itself."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        lead = x.ndim - len(lattice)
        if lead < 0 or tuple(x.shape[lead:]) != lattice:
            return x
        return x[(slice(None),) * lead + (slice(0, lattice[0] // 2),)]
    if isinstance(x, dict):
        out = {k: _cut(v, lattice) for k, v in x.items()}
        return out if any(out[k] is not v for k, v in x.items()) else x
    if isinstance(x, tuple):
        items = [_cut(v, lattice) for v in x]
        if all(a is b for a, b in zip(items, x)):
            return x
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def half_lattice(orig):
    """A diagnostic taken over the first half of the lattice's first axis,
    whatever its signature.  The lattice's axes are those of the first
    tensor argument past its leading (population) axis; every tensor or
    array argument that ends in them, inside a tuple, a named tuple or a
    dict too, is cut to the first half of the first of them: ``f[:,
    :ny // 2]`` for populations or a velocity, ``fluid[:ny // 2]`` for a
    mask, ``[:, :nz // 2]`` on a 3D lattice."""
    def diagnostic(*args, **kw):
        lattice = tuple(_first_tensor(args).shape[1:])
        return orig(*(_cut(a, lattice) for a in args),
                    **{k: _cut(v, lattice) for k, v in kw.items()})
    return diagnostic


def plant_half_lattice(config, monkeypatch):
    """Replace each diagnostic that ``config`` lists by its half-lattice
    fault."""
    for target in config["diagnostics"]:
        owner, attr, orig = resolve(target)
        monkeypatch.setattr(owner, attr, half_lattice(orig))
