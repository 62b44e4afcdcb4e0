"""Plaintext key-value config files, schema-compatible with the reference.

The reference parses per-app ``config_*.txt`` files with hand-rolled loops
(`#` starts a comment; one ``key value`` pair per line), e.g.
``Young_Laplace2D.h:459-491``, ``laplace2D.h:405-437``,
``rayleighTaylor2D.h:864-902``.  This loader reads those exact files.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Union

Number = Union[int, float]


def parse_config_text(text: str) -> Dict[str, str]:
    """Parse ``key value`` lines, stripping ``#`` comments (reference parser
    semantics, minus its getline/>> inconsistencies)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        if "#" in line:
            line = line[: line.index("#")]
        parts = line.split()
        if len(parts) >= 2:
            out[parts[0]] = parts[1]
    return out


def load_config(path) -> Dict[str, str]:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(
            f"Config file not found: {p} (reference behavior: throw invalid_argument)")
    return parse_config_text(p.read_text())


def coerce_into(cfg: Dict[str, str], dc_instance):
    """Return a dataclass copy with fields overridden by config values,
    coercing to the declared field types. Unknown keys are ignored with a
    warning list returned alongside (reference prints 'unknown parameter')."""
    fields = {f.name: f for f in dataclasses.fields(dc_instance)}
    updates = {}
    unknown = []
    for key, val in cfg.items():
        if key in fields:
            ftype = fields[key].type
            if ftype in ("int", int):
                updates[key] = int(float(val))
            elif ftype in ("float", float):
                updates[key] = float(val)
            elif ftype in ("bool", bool):
                updates[key] = val.lower() in ("1", "true", "yes")
            else:
                updates[key] = val
        else:
            unknown.append(key)
    return dataclasses.replace(dc_instance, **updates), unknown


def lb_parameters(ulb: float, lref: int, Re: float):
    """(ν, ω, dx, dt) from (u_lb, L_ref, Re) — reference
    ``lbParameters_*`` (laplace2D.h:52-58)."""
    nu = ulb * lref / Re
    omega = 1.0 / (3.0 * nu + 0.5)
    dx = 1.0 / lref
    dt = dx * ulb
    return nu, omega, dx, dt


def omega_from_tau(tau: float):
    """(ν, ω) from τ — reference laplace2D.h:443-447."""
    return (tau - 0.5) / 3.0, 1.0 / tau
