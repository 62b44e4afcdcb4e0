"""Readings that set the limits of ``correct``, on the card: for each seed,
one run of the cell (a window of ``--seconds``) whose numbers compared are
printed beside the control's, the plain reference computed one precision
below the cell's (float32 for float64, bfloat16 for float32) and put in the
program's place at the same sampled records and chunk.  Many seeds run in
one process, so set-up is paid once.

    python3 benchmark/calibrate.py --workload NAME --seeds 11,12,13 [--seconds 4]

One JSON line a seed: ``seed``, ``program`` and ``control`` readings,
``correct`` and ``control_correct`` under the cell's current limits.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    spec = harness.Spec(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run(spec, seed, args.seconds, False, "cuda", time.perf_counter(),
                        control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": {k: c["value"] for k, c in r["checks"].items()},
                          "control": r["control"], "correct": r["correct"],
                          "control_correct": r["control_correct"],
                          "max_steps": r["run"]["max_steps"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
