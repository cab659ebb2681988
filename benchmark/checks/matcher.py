"""The matcher: every call of the window (``capture.py``), its arguments and
its tables, against the plain tables. Number: ``match_diff``, table entries
that differ (exact; rows and columns that a borderline pair leaves
undetermined are not judged). The reference's tables are exact in either
precision, so there is no control reading."""

import torch

from benchmark.reference import hamming as ref_ham


def gather(run, rng):
    return run.capture.matches


def numbers(ev, cfg, device, control):
    if control:
        return {}
    diff = judged = 0
    for args, out in ev:
        a = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in args.items()}
        strict, loose = ref_ham.tables(a)
        d, j, _ = ref_ham.compare(ref_ham.Tables(*out), strict, loose)
        diff += d
        judged += j
    return {"match_diff": float(diff) if judged else None}


def notes(ev):
    return {"matcher_calls": len(ev)}
