"""CPU rehearsal of the benchmark: the whole run of a cell (case file,
set-up, the timed driver call, the check against the plain reference) at a
tiny lattice, through the program's plain PyTorch path.  It is a dry run of
the harness and measures nothing: its line is labelled ``rehearsal`` and
carries no metric and no device reading.

    python3 benchmark/rehearse.py [--workload NAME ...] [--seed N] [--seconds S]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def rehearse(workload, seed=1, seconds=1.0, control=False, t_start=None):
    """The rehearsal's result line for ``workload`` (a dict)."""
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.Spec(ROOT, workload)
    result = harness.run(spec, seed, seconds, False, "cpu",
                         time.perf_counter() if t_start is None else t_start,
                         shape=spec.config["rehearsal"], control=control)
    return {"rehearsal": workload, **result}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/rehearse.py")
    ap.add_argument("--workload", nargs="*")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    names = args.workload or [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    ok = True
    for name in names:
        res = rehearse(name, args.seed, args.seconds, control=True)
        ok &= res["correct"] and not res["control_correct"]
        print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
