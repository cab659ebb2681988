"""KITTI ground-truth poses (3x4 row-major per line) to the TUM quaternion
format (reference Examples/Monocular/ConvertGTtoQuaternion.cc:20-40), on
the port.

    python -m orbslamm_tpu_torch.examples.convert_gt_to_quaternion poses.txt [-o Quat.txt]

Each output line is ``tx ty tz qx qy qz qw``, with the rotation transposed
as the reference does; the file is byte for byte the JAX package's
script's.
"""

from __future__ import annotations

import argparse

from orbslamm_tpu_torch.io.trajectory import _rot_to_quat_np, load_kitti


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m orbslamm_tpu_torch.examples.convert_gt_to_quaternion")
    ap.add_argument("poses", help="KITTI ground-truth poses file (3x4 rows)")
    ap.add_argument("-o", "--out", default="Quat.txt")
    args = ap.parse_args(argv)
    T = load_kitti(args.poses)  # [N, 4, 4]
    with open(args.out, "w") as f:
        for Ti in T:
            t = Ti[:3, 3]
            q = _rot_to_quat_np(Ti[:3, :3].T)  # (qx, qy, qz, qw)
            f.write(f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")
    print(f"wrote {len(T)} poses to {args.out}")


if __name__ == "__main__":
    main()
