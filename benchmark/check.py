"""The comparison that decides ``correct``.

What the timed call produced is held against the configuration's plain
reference, run in float64 once the window has closed:

* ``state_err``: the populations the driver returned, which the kernel
  produced from the chunk that ends at ``max_steps`` to the end of the
  call, against the reference's as many steps from the state that entered
  that chunk; the largest absolute gap over the largest reference value,
  the worst tensor counting.
* ``record_err``: the ``.dat`` values the driver wrote at the sampled
  records (the last, and one drawn from the seed) against the reference's
  diagnostics of the state at those records; per column, the largest gap
  over the column's largest reference value.
* ``vtk_mismatch`` (cells that dump): the share of the sampled dumps'
  tokens that differ from the reference's own rendering of the same fields
  (a value under a millionth of its field's largest is round-off of a
  cancellation, and its digits are not compared).
* ``missing``: records and dumps missing or extra, against the count the
  run's length gives (an exact comparison).

The control (:func:`control_outputs`) puts the reference, computed in a
lower precision, in the program's place, through the same comparison.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

LOWER = {"float64": "float32", "float32": "bfloat16"}


def _gap(produced, expected):
    """max |p − e| / max |e| over each tensor pair; the worst pair."""
    worst = 0.0
    for p, e in zip(produced, expected):
        e = e.to(torch.float64)
        d = (p.to(device=e.device, dtype=torch.float64) - e).abs().max()
        scale = e.abs().max()
        v = float(d / scale) if float(scale) > 0 else float(d)
        worst = max(worst, v if math.isfinite(v) else math.inf)
    return worst


def _f64(state):
    return tuple(t.to(torch.float64) for t in state)


def expected_outputs(ref, prm, captured, last, dumps):
    """The reference's outputs in float64: the state ``n`` steps past the
    one kept in ``last = (it, state, n)``, the sampled records, and the
    tokens of the sampled dumps."""
    it, state, n = last
    return {"state": ref.step(_f64(state), prm, n),
            "records": ref.records({i: _f64(s) for i, s in captured.items()}, prm),
            "vtk": {i: ref.vtk_tokens(_f64(captured[i]), prm, i) for i in dumps}}


def control_outputs(ref, prm, captured, last, dumps, dtype_name):
    """The reference computed in ``LOWER[dtype_name]`` in the program's
    place."""
    low = getattr(torch, LOWER[dtype_name])
    cast = lambda s: tuple(t.to(low) for t in s)  # noqa: E731
    it, state, n = last
    return {"state": ref.step(cast(state), prm, n),
            "records": ref.records({i: cast(s) for i, s in captured.items()}, prm),
            "vtk": {i: ref.vtk_tokens(cast(captured[i]), prm, i) for i in dumps}}


def _dat(path: Path):
    return [[float(x) for x in line.split()] for line in path.read_text().splitlines()]


def program_outputs(final, outdir: Path, expected_records, dumps, ref):
    """What the program produced: the returned state, the lines of its
    ``.dat`` files at the sampled records, the tokens of its sampled dumps."""
    records = {}
    for name, lines in expected_records.items():
        rows = _dat(outdir / name) if (outdir / name).exists() else []
        records[name] = {i: rows[i] if i < len(rows) else None for i in lines}
    vtk = {}
    for i in dumps:
        path = outdir / ref.dump_name(i)
        vtk[i] = path.read_text().split() if path.exists() else None
    return {"state": final, "records": records, "vtk": vtk}


def compare(produced, expected, where=None) -> dict:
    """The numbers compared, from two sets of outputs (see the module note);
    ``where`` receives the place of each worst reading."""
    where = {} if where is None else where
    out = {"state_err": _gap(produced["state"], expected["state"])}
    worst = 0.0
    for name, lines in expected["records"].items():
        cols = list(zip(*lines.values()))
        scales = [max(abs(v) for v in c) or 1.0 for c in cols]
        for i, row in lines.items():
            got = produced["records"][name][i]
            if got is None or len(got) != len(row):
                where["record_err"] = f"{name} line {i} missing or malformed"
                return {**out, "record_err": math.inf}
            for col, (g, e, s) in enumerate(zip(got, row, scales)):
                v = abs(g - e) / s
                v = v if math.isfinite(v) else math.inf
                if v > worst:
                    worst = v
                    where["record_err"] = f"{name} line {i} column {col}: {g!r} against {e!r}"
    out["record_err"] = worst
    if expected["vtk"]:
        differ = total = 0
        for i, (tok, counted) in expected["vtk"].items():
            got = produced["vtk"][i]
            if isinstance(got, tuple):   # the control's own (tokens, counted)
                got = got[0]
            if got is None or len(got) != len(tok):
                differ, total = 1, 1
                break
            bad = [k for k, (a, b, c) in enumerate(zip(got, tok, counted)) if c and a != b]
            if bad:
                where[f"vtk_mismatch at it={i}"] = (
                    f"{len(bad)} tokens, first {[(k, got[k], tok[k]) for k in bad[:4]]}")
            differ += len(bad)
            total += sum(counted)
        out["vtk_mismatch"] = differ / total
    return out


def missing(outdir: Path, ref, prm, steps) -> int:
    """Records and dumps missing or extra against the run's length."""
    off = 0
    for name, n in ref.record_counts(prm, steps).items():
        path = outdir / name
        got = len(path.read_text().splitlines()) if path.exists() else 0
        off += abs(got - n)
    got = len(list(outdir.glob("*.vtk")))
    return off + abs(got - ref.dump_count(prm, steps))
