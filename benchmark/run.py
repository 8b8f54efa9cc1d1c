"""Run one cell of jasper_tpu_torch's benchmark once, on the card(s) of
this machine.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the split of its set-up and each compared number beside its limit
on standard error, and, as the last line of standard output, one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, breakdown (with
--trace 1) and checks. Exits non-zero, printing no result, without the
card(s) the cell asks for, when a module of JAX or of the JAX package
(jasper_tpu) is loaded, or on any failure of the harness itself.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    chips = harness.cell_of(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0), T_START)
    except harness.ForbiddenModules as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
