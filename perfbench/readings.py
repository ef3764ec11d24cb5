"""The readings a cell's limits are set from: the compared numbers of the
program's sound runs over many seeds, and of the control (the reference
one precision lower, in the program's place) over a few, each after a
short window at the cell's own load, all in one process.

    python3 perfbench/readings.py --workload table2-5.optimize \\
        --seeds 2147483800 --count 12 --control 3 --seconds 2

Prints one JSON line a run: ``{"who": "program" | "control", "seed",
"numbers"}``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, required=True, help="the first seed")
    p.add_argument("--count", type=int, default=12, help="the program's seeds")
    p.add_argument("--control", type=int, default=3, help="the control's seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness
    from perfbench.reference.dense import Control
    runs = [("program", args.seeds + i) for i in range(args.count)]
    runs += [("control", args.seeds + args.count + i) for i in range(args.control)]
    for who, seed in runs:
        t0 = time.perf_counter()
        spec, A, tracer, loop = harness.setup_cell(ROOT, args.workload, seed, args.seconds, False,
                                                     args.device)
        out = loop.window(args.seconds)
        nums = harness.compare_cell(A, loop, args.device,
                                    control=Control if who == "control" else None)
        nums["bad_status"] = out["bad_status"]
        print(json.dumps({"who": who, "seed": seed, "numbers": nums,
                          "correct": harness.check.judge(nums, spec["limits"]),
                          "attempted": out["attempted"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
