"""What the example command lines share: the reference drivers' arguments
(settings file, optional vocabulary, sequence, 1 for multi-mapping), the
port's ``--device`` and ``--viewer``, and the feeds over a sequence."""

from __future__ import annotations

import argparse

from orbslamm_tpu_torch.driver import RobotFeed


def parser(name: str, sequence_help: str | None = None, out: str = "out",
           two_robots: bool = True, sequence_name: str = "sequence") -> argparse.ArgumentParser:
    """settings [--vocabulary] sequence [multi_maps] [--two-robots] --out
    --max-frames --device --viewer."""
    ap = argparse.ArgumentParser(prog=f"python -m orbslamm_tpu_torch.examples.{name}")
    ap.add_argument("settings")
    ap.add_argument("--vocabulary", default=None,
                    help="pretrained vocabulary (.npz or DBoW2 ORBvoc.txt); "
                         "default: trained on the device")
    ap.add_argument("sequence", metavar=sequence_name, help=sequence_help)
    ap.add_argument("multi_maps", nargs="?", default="1")
    if two_robots:
        ap.add_argument("--two-robots", action="store_true")
    ap.add_argument("--out", default=out)
    ap.add_argument("--max-frames", type=int, default=0)
    add_run_args(ap)
    return ap


def add_run_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--viewer", type=int, default=0,
                    help="serve the live map viewer on this port")


def configure(cfg, args):
    """The settings file's config with the vocabulary and multi-mapping
    arguments applied."""
    if args.vocabulary:
        cfg = cfg.replace(vocabulary_path=args.vocabulary)
    return cfg.replace(multi_mapping=args.multi_maps == "1")


def frames(seq, lo: int, hi: int):
    """(timestamp, image) of frames lo..hi-1, decoded one by one."""
    for i in range(lo, hi):
        yield seq.timestamps[i], seq.frame(i)


def n_frames(seq, max_frames: int) -> int:
    return len(seq) if not max_frames else min(len(seq), max_frames)


def halves(seq, n: int, two_robots: bool) -> list[RobotFeed]:
    """One robot over the sequence, or two over its halves."""
    if not two_robots:
        return [RobotFeed(frames(seq, 0, n), "robot0")]
    half = n // 2
    return [RobotFeed(frames(seq, 0, half), "robot0"), RobotFeed(frames(seq, half, n), "robot1")]
