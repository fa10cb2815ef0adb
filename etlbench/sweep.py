"""The sweep that found the online cell's rate (run once, on the card; not
by ``run.py``): the ``online`` mode of a cell at each of a few rates, one
run a rate in this process after one set-up of the library, printing the
event age p95, the events shed and failed, and the steps trained.

    python3 etlbench/sweep.py --workload dlrm_mlperf.online --rates 4 5 6 7 --seconds 20

The highest rate with nothing shed or failed and an event age p95 under
the shedder's bound is the knee; the cell's ``rate_hz`` is four fifths
of it.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from etlbench import drive, run

    cell = run.resolve(run.load_bench(ROOT), args.workload, ROOT)
    for rate in args.rates:
        traffic = copy.deepcopy(cell["traffic"])
        traffic["rate_hz"] = rate
        out = drive.execute(args.workload, cell["config"], traffic,
                            args.seed, args.seconds, False, "cuda:0",
                            time.perf_counter(), {})
        print(json.dumps({"rate_hz": rate, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "metrics": out["metrics"],
                          "readings": out.get("readings")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
