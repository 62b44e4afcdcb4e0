"""Host us a lattice step in the stepping entry's kernel wrapper: the
``kernel.prepare`` (checks, constants, the launch grid, buffers) and
``kernel.enqueue`` (the C call) spans of the cell's kernel family in the
traced slice, over the steps those calls launched, from the program's own
spans.  A call of more steps than the card's launch queue holds (about a
thousand launches) blocks inside the C call until the device drains the
queue, so there the reading holds device time too."""
from benchmark import program_trace


def read(run):
    got = program_trace.in_slice(run)
    if got is None:
        return None
    family = run.spec.config["work"]["family"]
    mine = [s for s in got[0] if s.name in ("kernel.prepare", "kernel.enqueue")
            and s.attrs.get("family") == family]
    steps = sum(s.attrs["steps"] for s in mine if s.name == "kernel.enqueue")
    if not steps:
        return None
    return 1e6 * sum(s.t1 - s.t0 for s in mine) / steps
