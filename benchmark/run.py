"""The benchmark's command: one run of one workload on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  It needs a CUDA card (and as many as the
workload asks for): without one it exits with code 3 and prints no result.
Where the process holds JAX or the JAX package once the window has closed
and the check has run, it exits with code 4, names them on standard error
and prints no result.
The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
The program's own prints (the driver's MLUPS lines, nvcc's report) go to
standard error.  Kernel caches stay inside the checkout: the program builds
its library under ``multiphase_lbm_tpu_torch/_build/``, and the PyTorch
extension and Triton caches are pointed at ``.bench_cache/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness

    spec = harness.Spec(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"benchmark: {args.workload} needs {spec.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    try:
        result = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except harness.ForeignModules as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
