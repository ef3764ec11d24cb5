"""The rate sweep of a served cell: the cell's traffic at each offered rate
for a window, in one process, to find the highest rate at which the
backlog does not grow.

    python3 perfbench/sweep.py --workload table2-5.served --rates 300,400,500 --seconds 8

Prints one JSON line a rate: completed a second, latency percentiles,
requests unfinished when the window closed, and the median latency of the
window's last third against its first (a growing queue raises it).
"""
import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=2147483900)
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        spec, A, tracer, loop = harness.setup_cell(ROOT, args.workload, args.seed + i,
                                                   args.seconds, False,
                                                   mix_override={"rate": rate})
        out = loop.window(args.seconds)
        lat = np.asarray(loop.lat) * 1e3
        third = max(1, len(lat) // 3)
        fin = np.isfinite(lat)
        pct = lambda q: float(np.sort(lat)[max(0, math.ceil(q * len(lat)) - 1)])
        print(json.dumps({
            "rate": rate, "requests": len(lat), "failed": int((~fin).sum()),
            "completed_per_s": float(fin.sum() / out["window_s"]),
            "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
            "first_third_median_ms": float(np.median(lat[:third])),
            "last_third_median_ms": float(np.median(lat[-third:])),
            "unfinished_at_close": out["unfinished_at_close"],
            "lag_p95_ms": out["lag_p95_ms"]}), flush=True)
        loop.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
