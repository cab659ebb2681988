"""New College monocular driver (reference
Examples/Monocular/mono_NewCollege.cc), on the port.

    python -m orbslamm_tpu_torch.examples.mono_newcollege settings.yaml sequence_dir [1]
        [--vocabulary voc] [--two-robots] [--out dir] [--max-frames N]
        [--device cuda|cpu] [--viewer PORT]

``sequence_dir`` holds ``times.txt`` and ``right/filenames.txt`` (the right
camera). ``--two-robots`` runs the two halves as two robots.
"""

from __future__ import annotations

from orbslamm_tpu_torch.driver import autodetect_image_size, run_robots
from orbslamm_tpu_torch.examples import _cli
from orbslamm_tpu_torch.io.datasets import load_newcollege_sequence
from orbslamm_tpu_torch.utils.config import load_settings


def main(argv=None):
    args = _cli.parser("mono_newcollege", out="out_newcollege").parse_args(argv)
    cfg = _cli.configure(load_settings(args.settings), args)
    seq = load_newcollege_sequence(args.sequence)
    n = _cli.n_frames(seq, args.max_frames)
    cfg = autodetect_image_size(cfg, seq.frame(0))
    run_robots(cfg, _cli.halves(seq, n, args.two_robots), out_dir=args.out,
               viewer_port=args.viewer or None, device=args.device)


if __name__ == "__main__":
    main()
