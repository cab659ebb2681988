"""AGZ (Zurich urban MAV) monocular driver (reference SingleRobotScenario
Examples/Monocular/mono_AGZ.cc), on the port. Every ``--stride``-th frame
(5, the reference's ``ni+=5``) is processed.

    python -m orbslamm_tpu_torch.examples.mono_agz settings.yaml sequence_dir [1]
        [--vocabulary voc] [--stride 5] [--out dir] [--max-frames N]
        [--device cuda|cpu] [--viewer PORT]

``sequence_dir`` holds ``filenames.txt`` and ``MAVImages/``. Unlike the JAX
package's script, ``--viewer`` is passed on to the driver.
"""

from __future__ import annotations

from orbslamm_tpu_torch.driver import RobotFeed, autodetect_image_size, run_robots
from orbslamm_tpu_torch.examples import _cli
from orbslamm_tpu_torch.io.datasets import load_agz_sequence
from orbslamm_tpu_torch.utils.config import load_settings


def main(argv=None):
    ap = _cli.parser("mono_agz", "folder with filenames.txt + MAVImages/", out="out_agz",
                     two_robots=False)
    ap.add_argument("--stride", type=int, default=5)
    args = ap.parse_args(argv)
    cfg = _cli.configure(load_settings(args.settings), args)
    seq = load_agz_sequence(args.sequence, stride=args.stride)
    n = _cli.n_frames(seq, args.max_frames)
    cfg = autodetect_image_size(cfg, seq.frame(0))
    run_robots(cfg, [RobotFeed(_cli.frames(seq, 0, n), "robot0")], out_dir=args.out,
               viewer_port=args.viewer or None, device=args.device)


if __name__ == "__main__":
    main()
