"""The check that decides ``correct``: what the window's calls produced,
against the plain reference (``benchmark/reference``), after the window.

A cell's mix names its checks (``"checks"``), each a module
``benchmark/checks/<name>.py`` with ``gather(run, rng)``, which takes from
the finished run what is to be judged (and nothing that the reference has
to work out again), ``numbers(evidence, cfg, device, control)``, which
reads each number (the larger the worse), and ``notes(evidence)``, what
the result line shows beside them. ``gather`` runs while the program's
state is alive, ``numbers`` once it is freed. With ``control`` the
reference in TF32 stands in the port's place and its answers are judged in
the same way; a check with no control reading returns none.
"""

from __future__ import annotations

import importlib
import random


def _module(name: str):
    return importlib.import_module(f"benchmark.checks.{name}")


def gather(run) -> dict:
    rng = random.Random(run.seed)
    return {name: _module(name).gather(run, rng) for name in run.cell.mix["checks"]}


def numbers(evidence: dict, cfg, device, control: bool = False) -> dict:
    out = {}
    for name, ev in evidence.items():
        out.update(_module(name).numbers(ev, cfg, device, control))
    return out


def notes(evidence: dict) -> dict:
    out = {}
    for name, ev in evidence.items():
        out.update(_module(name).notes(ev))
    return out
