"""Two robots on two different KITTI sequences, one MultiMapper (reference
mono_kitti_dif-Seq.cc, "the first SLAM system working simultaneously on
KITTI 00 and 07"), on the port.

    python -m orbslamm_tpu_torch.examples.mono_kitti_dif_seq settings1 seq1 [1] seq2 settings2
        [--vocabulary voc] [--out dir] [--max-frames N] [--device cuda|cpu]
        [--viewer PORT]

As in the JAX package's script, one ``SlamConfig``, read from
``settings1``, drives both robots (extraction and the camera model):
``settings2`` is parsed as an argument but not read. Each robot's frames
are ``seq1`` and ``seq2``, cut to ``--max-frames``.
"""

from __future__ import annotations

import argparse

from orbslamm_tpu_torch.driver import RobotFeed, autodetect_image_size, run_robots
from orbslamm_tpu_torch.examples import _cli
from orbslamm_tpu_torch.io.datasets import load_kitti_sequence
from orbslamm_tpu_torch.utils.config import load_settings


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m orbslamm_tpu_torch.examples.mono_kitti_dif_seq")
    ap.add_argument("settings1")
    ap.add_argument("seq1")
    ap.add_argument("multi_maps", nargs="?", default="1")
    ap.add_argument("seq2")
    ap.add_argument("settings2", help="parsed, not read: settings1 drives both robots")
    ap.add_argument("--vocabulary", default=None,
                    help="pretrained vocabulary (.npz or DBoW2 ORBvoc.txt)")
    ap.add_argument("--out", default="out_kitti2")
    ap.add_argument("--max-frames", type=int, default=0)
    _cli.add_run_args(ap)
    args = ap.parse_args(argv)
    cfg = load_settings(args.settings1).replace(multi_mapping=args.multi_maps == "1",
                                                vocabulary_path=args.vocabulary)
    s1, s2 = load_kitti_sequence(args.seq1), load_kitti_sequence(args.seq2)
    cfg = autodetect_image_size(cfg, s1.frame(0))
    feeds = [RobotFeed(_cli.frames(s1, 0, _cli.n_frames(s1, args.max_frames)), "robot0"),
             RobotFeed(_cli.frames(s2, 0, _cli.n_frames(s2, args.max_frames)), "robot1")]
    run_robots(cfg, feeds, out_dir=args.out, viewer_port=args.viewer or None,
               device=args.device)


if __name__ == "__main__":
    main()
