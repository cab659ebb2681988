"""Capture of the answers that the window's calls produce, for the check
that runs after the window.

While the window runs, ``Capture`` stands in for two functions of the
program that are looked up through their module at every call: the
matcher's ``match_tables`` (``ops/cuda/hamming``) and the motion-only BA
``pose_optimize`` (``ops/ba``). It forwards each call unchanged and keeps,
for every matcher call and for a uniform sample of ``pose_samples`` pose
solves (a reservoir drawn from ``rng``, the run's seed), copies of the
arguments and of the answer on the device (a few device copies a call;
nothing is read back to the host). It
restores both functions when the window closes.
"""

from __future__ import annotations

import torch


def _copy(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if hasattr(x, "_fields"):  # the matcher's and the pose solve's answers
        return type(x)(*(_copy(v) for v in x))
    return x


MATCH_ARGS = ("desc_a", "desc_b", "valid_a", "valid_b", "xy_a", "xy_b", "radius_b",
              "level_a", "level_b", "lines_a", "epi_thr_b")
POSE_ARGS = ("T_init", "K", "pts_w", "uv_obs", "valid", "sigma2", "rounds", "iters",
             "chi2_th", "ur_obs", "bf")


def _bind(names, defaults, args, kw):
    out = dict(defaults)
    out.update(zip(names, args))
    out.update(kw)
    return out


class Capture:
    def __init__(self, hamming_mod, ba_mod, pose_samples: int, rng):
        self.hamming = hamming_mod
        self.ba = ba_mod
        self.pose_samples = pose_samples
        self.rng = rng
        self.matches: list[tuple[dict, tuple]] = []
        self.poses: list[tuple[dict, tuple]] = []
        self.pose_calls = 0

    def __enter__(self):
        self._match, self._pose = self.hamming.match_tables, self.ba.pose_optimize
        match_defaults = dict(xy_a=None, xy_b=None, radius_b=None, level_a=None,
                              level_b=None, lines_a=None, epi_thr_b=None, lvl_lo=-1e9,
                              lvl_hi=1e9, use_window=False, use_epipolar=False)
        pose_defaults = dict(sigma2=1.0, rounds=4, iters=10, chi2_th=self.ba.CHI2_MONO,
                             ur_obs=None, bf=0.0)

        def match_tables(*args, **kw):
            out = self._match(*args, **kw)
            self.matches.append((_copy(_bind(MATCH_ARGS, match_defaults, args, kw)), _copy(out)))
            return out

        def pose_optimize(*args, **kw):
            out = self._pose(*args, **kw)
            i = self.pose_calls
            slot = i if i < self.pose_samples else self.rng.randrange(i + 1)
            if slot < self.pose_samples:
                kept = (_copy(_bind(POSE_ARGS, pose_defaults, args, kw)), _copy(out))
                if slot < len(self.poses):
                    self.poses[slot] = kept
                else:
                    self.poses.append(kept)
            self.pose_calls += 1
            return out

        self.hamming.match_tables = match_tables
        self.ba.pose_optimize = pose_optimize
        return self

    def __exit__(self, *exc):
        self.hamming.match_tables = self._match
        self.ba.pose_optimize = self._pose
        return False
