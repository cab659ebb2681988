"""A demo on the synthetic renderer, no dataset needed, on the port.

    python -m orbslamm_tpu_torch.examples.mono_synthetic [--scenario kidnap|two-robot|vo]
        [--frames 60] [--out dir] [--device cuda|cpu] [--viewer PORT]

``kidnap``: one robot whose camera jumps elsewhere half way (a tracking
loss, then a new map); ``two-robot``: two robots on overlapping halves of
one sequence; ``vo``: one robot over the whole sequence. The run writes
trajectories, the maps and their renderings into ``--out``. The JAX
package's script reads an ``args.viewer`` its parser never defines and
stops before its run; this one defines ``--viewer`` and passes it on.
"""

from __future__ import annotations

import argparse

from orbslamm_tpu_torch.driver import RobotFeed, run_robots
from orbslamm_tpu_torch.examples import _cli
from orbslamm_tpu_torch.io.synthetic import make_sequence
from orbslamm_tpu_torch.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)

CAMERA = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
CONFIG = SlamConfig(
    camera=CAMERA,
    orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
    capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=55, init_min_triangulated=30,
                            init_min_parallax_deg=0.4),
)


def scenario(name: str, n: int):
    """The scenario's sequence and its robots' (name, first, end) frames."""
    if name == "kidnap":
        seq = make_sequence(n_frames=n, n_points=1400, cam=CAMERA, seed=7, kidnap_at=n // 2)
        return seq, [("robot0", 0, n)]
    seq = make_sequence(n_frames=n, n_points=1400, cam=CAMERA, seed=7)
    if name == "two-robot":
        return seq, [("robot0", 0, min(n, n // 2 + 8)), ("robot1", n // 2, n)]
    return seq, [("robot0", 0, n)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m orbslamm_tpu_torch.examples.mono_synthetic")
    ap.add_argument("--scenario", choices=["kidnap", "two-robot", "vo"], default="kidnap")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="out_synthetic")
    _cli.add_run_args(ap)
    args = ap.parse_args(argv)
    seq, robots = scenario(args.scenario, args.frames)

    def feed(lo, hi):
        for i in range(lo, hi):
            yield seq.timestamps[i], seq.images[i]

    run_robots(CONFIG, [RobotFeed(feed(lo, hi), name) for name, lo, hi in robots],
               out_dir=args.out, viewer_port=args.viewer or None, device=args.device)


if __name__ == "__main__":
    main()
