"""The control of the check, at a cell's own size: the plain reference in
TF32 stands in the port's place, its answers judged as the port's are.

    python3 benchmark/control.py <cell> <seed> [<seed> ...] [--seconds S]

One process runs the cell once per seed (set-up, the window at the cell's
own load, then both checks) and prints a JSON line per seed: ``correct``
and ``check``, the port's verdict and numbers beside their limits, and
``control_correct`` and ``control``, the control's, judged by the same
``harness.judge``. A limit has to lie between the port's readings and the
control's. Not run by the benchmark's own runs.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import torch

    from benchmark import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--seconds", type=int, default=None)
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.cell)
    seconds = a.seconds or harness.load_json(harness.ROOT / "BENCHMARK.json")["run_seconds"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in a.seeds:
        res = harness.execute(cell, seed, seconds, False, device, control=True)
        print(json.dumps({"cell": a.cell, "seed": seed, "correct": res["correct"],
                          "check": res["check"], "not_compared": res["setup"]["not_compared"],
                          "control_correct": res["control"]["correct"],
                          "control": res["control"]["check"],
                          "metrics": res["metrics"], "setup": res["setup"]}), flush=True)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
