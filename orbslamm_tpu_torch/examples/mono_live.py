"""Live-camera monocular driver (reference Examples/Monocular/mono_Bebop.cc),
on the port.

    python -m orbslamm_tpu_torch.examples.mono_live settings.yaml source [1]
        [--vocabulary voc] [--out dir] [--max-frames N] [--device cuda|cpu]
        [--viewer PORT]

``source`` is an OpenCV ``VideoCapture`` source: a V4L2 device index (the
v4l2loopback device the reference's Bebop H.264-FIFO pipeline feeds), a
video file, an image pattern such as ``img_%03d.png``, or a stream URL.
Frames are taken at capture rate and stamped with the monotonic clock.
Unlike the JAX package's script, ``--viewer`` is passed on to the driver.
"""

from __future__ import annotations

from orbslamm_tpu_torch.driver import RobotFeed, autodetect_image_size, run_robots
from orbslamm_tpu_torch.examples import _cli
from orbslamm_tpu_torch.io.datasets import video_capture_frames
from orbslamm_tpu_torch.utils.config import load_settings


def main(argv=None):
    ap = _cli.parser("mono_live", "device index, video file, or stream URL", out="out_live",
                     two_robots=False, sequence_name="source")
    args = ap.parse_args(argv)
    cfg = _cli.configure(load_settings(args.settings), args)
    src = int(args.sequence) if args.sequence.isdigit() else args.sequence
    frames = video_capture_frames(src, max_frames=args.max_frames)
    ts0, img0 = next(frames)
    cfg = autodetect_image_size(cfg, img0)

    def stream():
        yield ts0, img0
        yield from frames

    run_robots(cfg, [RobotFeed(stream(), "robot0")], out_dir=args.out,
               viewer_port=args.viewer or None, device=args.device)


if __name__ == "__main__":
    main()
