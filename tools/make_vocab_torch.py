"""Train the framework's vocabulary data file with the PyTorch/CUDA port
(the port of tools/make_vocab.py).

The reference ships a pretrained DBoW2 tree (ORBvoc.txt, trained offline on
generic imagery). This tool is the training counterpart: it extracts ORB
descriptors from a pool of rendered synthetic scenes (eight worlds, three
motions, every third of 12 frames, 640x480, 1000 features) with the port's
extractor, trains the hierarchical k-majority vocabulary with the port's
``ops/bow.build_vocabulary`` and writes the ``.npz`` that
``SlamConfig.vocabulary_path`` loads in either package.

Usage:  python tools/make_vocab_torch.py [branching] [depth] [out.npz] [--device cuda|cpu]

The default output is ``build/vocab_<branching>x<depth>.npz``; the file the
sessions load, ``orbslamm_tpu/data/vocab_10x4.npz``, is never written.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent

# the pool: worlds (make_sequence seeds s * 31 + 7), motions, frames per
# sequence and the stride between extracted frames
N_WORLDS = 8
MOTIONS = ("forward", "strafe", "orbit")
SEQ_FRAMES, FRAME_STRIDE = 12, 3


def pool_camera():
    from orbslamm_tpu_torch.utils.config import CameraConfig

    return CameraConfig(width=640, height=480, fx=520.9, fy=521.0, cx=325.1, cy=249.7)


def pool_orb():
    from orbslamm_tpu_torch.utils.config import OrbConfig

    return OrbConfig(n_features=1000, max_keypoints=2048)


def default_out(branching: int, depth: int) -> Path:
    return _REPO / "build" / f"vocab_{branching}x{depth}.npz"


def pool_images(cam, n_worlds: int | None = None):
    """The pool's frames, in order: a spread of worlds (N_WORLDS unless
    given), viewpoints and motions, so the words cover the descriptor
    distribution, not one scene."""
    from orbslamm_tpu_torch.io.synthetic import make_sequence

    for seed in range(N_WORLDS if n_worlds is None else n_worlds):
        for motion in MOTIONS:
            seq = make_sequence(n_frames=SEQ_FRAMES, n_points=2500, cam=cam,
                                seed=seed * 31 + 7, motion=motion)
            yield from seq.images[::FRAME_STRIDE]


def descriptor_pool(cam, orb_cfg, n_worlds: int | None = None, *, device) -> np.ndarray:
    """[N, 32] uint8: every valid descriptor of the pool's frames."""
    from orbslamm_tpu_torch.ops import orb as orb_ops

    extract = orb_ops.make_extractor(orb_cfg, cam, device=device)
    descs = []
    for image in pool_images(cam, n_worlds):
        f = extract(image)
        descs.append(f.desc[f.valid].cpu().numpy())
    return np.concatenate(descs, axis=0)


def main(argv=None) -> int:
    import torch

    from orbslamm_tpu_torch.ops import bow

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("branching", nargs="?", type=int, default=10)
    ap.add_argument("depth", nargs="?", type=int, default=4)
    ap.add_argument("out", nargs="?", type=Path, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("make_vocab_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    out = args.out or default_out(args.branching, args.depth)
    t0 = time.perf_counter()
    alld = descriptor_pool(pool_camera(), pool_orb(), device=args.device)
    t_pool = time.perf_counter() - t0
    print(f"training on {len(alld)} descriptors -> {args.branching}^{args.depth} words",
          flush=True)
    t0 = time.perf_counter()
    voc = bow.build_vocabulary(alld, branching=args.branching, depth=args.depth, iters=8,
                               seed=3, max_train=32768, device=args.device)
    if args.device == "cuda":
        torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    out.parent.mkdir(parents=True, exist_ok=True)
    bow.save_vocabulary_npz(voc, out)
    print(f"saved {out} ({out.stat().st_size / 1024:.0f} KiB); pool {t_pool:.2f} s, "
          f"training {t_train:.3f} s on {args.device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(_REPO))
    sys.exit(main())
