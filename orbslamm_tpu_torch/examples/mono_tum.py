"""TUM monocular driver (reference Examples/Monocular/mono_tum.cc), on the
port.

    python -m orbslamm_tpu_torch.examples.mono_tum settings.yaml sequence_dir [1]
        [--vocabulary voc.npz|ORBvoc.txt] [--two-robots] [--out dir]
        [--max-frames N] [--device cuda|cpu]

The third argument is 1 for multi-mapping (a new map on tracking loss).
``--two-robots`` splits the sequence in half and runs both halves through
one MultiMapper, like the reference's MultipleRobotsScenario variant
(mono_tum.cc:74-114). Frames are decoded one by one with
``datasets.imread_gray`` (OpenCV, else PIL), as the JAX package's driver
decodes them. The run writes trajectories, the maps and the Tracer's
report into ``--out`` (``driver.save_outputs``). ``--viewer`` (the live
viewer) is ROADMAP queue 1 step 15b and exits with an error.
"""

from __future__ import annotations

import argparse

from orbslamm_tpu_torch.driver import RobotFeed, autodetect_image_size, run_robots
from orbslamm_tpu_torch.io.datasets import load_tum_sequence
from orbslamm_tpu_torch.utils.config import load_settings


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m orbslamm_tpu_torch.examples.mono_tum")
    ap.add_argument("settings")
    ap.add_argument("--vocabulary", default=None,
                    help="pretrained vocabulary (.npz or DBoW2 ORBvoc.txt); "
                         "default: trained on the device")
    ap.add_argument("sequence")
    ap.add_argument("multi_maps", nargs="?", default="1")
    ap.add_argument("--two-robots", action="store_true")
    ap.add_argument("--out", default="out_tum")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--viewer", type=int, default=0,
                    help="the live map viewer (not ported yet: ROADMAP queue 1 step 15b)")
    args = ap.parse_args(argv)
    if args.viewer:
        ap.error("--viewer: the live viewer is not ported yet (ROADMAP queue 1 step 15b)")

    cfg = load_settings(args.settings)
    if args.vocabulary:
        cfg = cfg.replace(vocabulary_path=args.vocabulary)
    cfg = cfg.replace(multi_mapping=args.multi_maps == "1")
    seq = load_tum_sequence(args.sequence)
    n = len(seq) if not args.max_frames else min(len(seq), args.max_frames)
    cfg = autodetect_image_size(cfg, seq.frame(0))

    def frames(lo, hi):
        for i in range(lo, hi):
            yield seq.timestamps[i], seq.frame(i)

    if args.two_robots:
        half = n // 2
        feeds = [RobotFeed(frames(0, half - 200 if half > 200 else half), "robot0"),
                 RobotFeed(frames(half, n), "robot1")]
    else:
        feeds = [RobotFeed(frames(0, n), "robot0")]
    run_robots(cfg, feeds, out_dir=args.out, device=args.device)


if __name__ == "__main__":
    main()
