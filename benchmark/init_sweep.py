"""Set-up alone, over seeds: whether a cell's robot initializes, and at
which frame (the run's initialization segment, ``init_frames`` of the
cell's mix; the window's frames are not rendered).

    python3 benchmark/init_sweep.py <cell> <first seed> <last seed>

Prints one JSON line per seed: the frame after which the robot had
``init_streak`` frames in a row tracked, or the failure, and the seconds.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv) -> int:
    import torch

    from benchmark import harness, scene

    name, lo, hi = argv[0], int(argv[1]), int(argv[2])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = harness.load_cell(name)
    cfg = harness.slam_config(cell.conf)
    mix = dict(cell.mix)
    seconds = harness.load_json(harness.ROOT / "BENCHMARK.json")["run_seconds"]
    ok = 0
    for seed in range(lo, hi + 1):
        t0 = time.perf_counter()
        # the frames a run of the benchmark's length renders, up to the end
        # of the initialization segment
        streams = scene.streams(mix, harness.scene_camera(cell.conf), seed, seconds,
                                device=device, frames=int(mix["init_frames"]))
        run = harness.Run(cell=cell, seed=seed, device=device)
        driver = harness.SessionDriver(run, cfg, streams)
        line = {"cell": name, "seed": seed}
        try:
            line["init_frames"] = driver.initialize(int(mix["init_streak"]),
                                                    int(mix["init_frames"]))
            ok += 1
        except harness.RunFailed as e:
            line["failed"] = str(e)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        driver.release()
    print(json.dumps({"cell": name, "seeds": hi - lo + 1, "initialized": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
