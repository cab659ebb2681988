"""TUM monocular driver (reference Examples/Monocular/mono_tum.cc), on the
port.

    python -m orbslamm_tpu_torch.examples.mono_tum settings.yaml sequence_dir [1]
        [--vocabulary voc.npz|ORBvoc.txt] [--two-robots] [--out dir]
        [--max-frames N] [--device cuda|cpu] [--viewer PORT]

The third argument is 1 for multi-mapping (a new map on tracking loss).
``--two-robots`` splits the sequence in half and runs both halves through
one MultiMapper, like the reference's MultipleRobotsScenario variant
(mono_tum.cc:74-114). Frames are decoded one by one with
``datasets.imread_gray`` (OpenCV, else PIL), as the JAX package's driver
decodes them. The run writes trajectories, the maps, their renderings and
the Tracer's report into ``--out`` (``driver.save_outputs``); ``--viewer``
serves the live viewer on that port while it runs.
"""

from __future__ import annotations

from orbslamm_tpu_torch.driver import RobotFeed, autodetect_image_size, run_robots
from orbslamm_tpu_torch.examples import _cli
from orbslamm_tpu_torch.io.datasets import load_tum_sequence
from orbslamm_tpu_torch.utils.config import load_settings


def main(argv=None):
    args = _cli.parser("mono_tum", out="out_tum").parse_args(argv)
    cfg = _cli.configure(load_settings(args.settings), args)
    seq = load_tum_sequence(args.sequence)
    n = _cli.n_frames(seq, args.max_frames)
    cfg = autodetect_image_size(cfg, seq.frame(0))
    if args.two_robots:
        half = n // 2
        feeds = [RobotFeed(_cli.frames(seq, 0, half - 200 if half > 200 else half), "robot0"),
                 RobotFeed(_cli.frames(seq, half, n), "robot1")]
    else:
        feeds = [RobotFeed(_cli.frames(seq, 0, n), "robot0")]
    run_robots(cfg, feeds, out_dir=args.out, viewer_port=args.viewer or None,
               device=args.device)


if __name__ == "__main__":
    main()
