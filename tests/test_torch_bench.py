"""bench_torch.py, the port of bench.py, against bench.py on the CPU.

  * ``_cfg()`` equals bench.py's field by field (the JAX package's config
    object as a dict against the port's);
  * the result keys: each dict literal that bench.py's ``bench_single``,
    ``bench_multi`` and ``main`` build, and each key ``main`` sets on its
    line, against bench_torch.py's (read from both sources);
  * a test-size run of ``bench_torch.main(["--device", "cpu"])``: bench.py's
    320x240 test configuration (tests/test_torch_host_path.py's) on a
    SINGLE_FRAMES = 32 sequence, so that one chunk (CHUNK frames) is timed,
    with phase 2 stubbed to report that a robot did not initialize; both
    printed lines carry bench.py's keys plus ``device``, the result's keys
    are bench.py's ``bench_single`` keys, and a run in which phase 1 fails
    prints bench.py's error line and returns 1;
  * chip_smoke.py's bank path and bench_torch.py run one two-robot
    scenario: the smoke's configuration is ``bench_torch._cfg()``, its
    seeds, sequence, halves, robot names and chunk are bench_torch's, and
    its ``_bank_run`` goes through ``bench_torch.bench_multi`` with its
    robots over ``stream_mesh()``.
"""

import ast
import dataclasses
import json
import os
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from orbslamm_tpu_torch.utils import config as tc

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402


def _bench_py():
    """bench.py as a module; its import sets JAX_COMPILATION_CACHE_DIR,
    which is put back as it was."""
    saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    import bench

    if saved is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = saved
    return bench


def _small_cfg():
    cam = tc.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
    return tc.SlamConfig(
        camera=cam,
        orb=tc.OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
        capacity=tc.CapacityConfig(max_keyframes=64, max_landmarks=4096),
        tracking=tc.TrackingConfig(pixel_noise=1.2, min_matches_init=55,
                                   init_min_triangulated=30, init_min_parallax_deg=0.4))


def test_cfg_equals_bench_py():
    want, got = dataclasses.asdict(_bench_py()._cfg()), dataclasses.asdict(bench_torch._cfg())
    assert got == want and got["vocabulary_path"] == str(REPO / "orbslamm_tpu" / "data"
                                                         / "vocab_10x4.npz")


def _keys(path, func):
    """The keys ``func`` puts in its result: those of the dict literal each
    ``return`` hands back (``return {...}, None`` or ``return done({...},
    None)``), and those of ``out``, the output line (``out = {...}`` and
    ``out["key"] = ...``)."""
    tree = ast.parse(Path(path).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)

    def literal(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Return) and n.value is not None:
            first = (n.value.elts[0] if isinstance(n.value, ast.Tuple) and n.value.elts
                     else n.value.args[0] if isinstance(n.value, ast.Call) and n.value.args
                     else None)
            if isinstance(first, ast.Dict):
                keys |= literal(first)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == "out" and isinstance(n.value, ast.Dict):
                    keys |= literal(n.value)
                elif (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                      and t.value.id == "out" and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return keys


@pytest.mark.parametrize("func", ["bench_single", "bench_multi", "main"])
def test_result_keys_equal_bench_py(func):
    want = _keys(REPO / "bench.py", func)
    got = _keys(REPO / "bench_torch.py", func)
    assert want  # the reading found bench.py's keys
    if func == "main":  # the line's phase-1 keys are set in single_line
        got |= _keys(REPO / "bench_torch.py", "single_line")
        assert got == want | {"device"}
    else:
        assert got == want


def test_main_prints_bench_py_lines_at_test_size(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "_cfg", _small_cfg)
    monkeypatch.setattr(bench_torch, "SINGLE_FRAMES", 32)
    singles = []
    real_single = bench_torch.bench_single

    def single(*a, **k):
        singles.append(real_single(*a, **k))
        return singles[-1]

    monkeypatch.setattr(bench_torch, "bench_single", single)
    monkeypatch.setattr(bench_torch, "bench_multi",
                        lambda cfg, seed, device: (None, "robot 0 failed to initialize"))
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    main_keys = _keys(REPO / "bench.py", "main") - {"error"}
    assert len(lines) == 2 and set(lines[0]) == main_keys - {"multi"} | {"device"}
    assert set(lines[1]) == main_keys | {"device"} and lines[1]["device"] == "cpu"
    assert lines[1]["multi"] == {"error": "robot 0 failed to initialize"}
    result = singles[-1][0]
    assert set(result) == _keys(REPO / "bench.py", "bench_single")
    assert lines[0]["value"] == result["fps"] > 0
    # phase 1 fails on both seeds: bench.py's error line, exit 1
    monkeypatch.setattr(bench_torch, "bench_single",
                        lambda cfg, seed, device: (None, "initialization failed"))
    assert bench_torch.main(["--device", "cpu"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and lines[0]["error"] == "initialization failed"
    assert set(lines[0]) == {"metric", "value", "unit", "vs_baseline", "error", "device"}


def test_smoke_and_bench_torch_run_one_multi_scenario(monkeypatch):
    assert chip_smoke.multimap_cfg() == bench_torch._cfg()
    assert chip_smoke.BANK_SEEDS == bench_torch.MULTI_SEEDS
    assert (chip_smoke.MM_FRAMES, chip_smoke.MM_HALF, chip_smoke.MM_NAMES, chip_smoke.CHUNK) == (
        bench_torch.MULTI_FRAMES, bench_torch.MULTI_HALF, bench_torch.MULTI_NAMES,
        bench_torch.CHUNK)
    from orbslamm_tpu_torch.parallel import multihost

    meshes, calls = [], []
    monkeypatch.setattr(multihost, "stream_mesh",
                        lambda devices=None: meshes.append(devices) or "mesh")

    def bench_multi(cfg, seed, device, mesh, details):
        calls.append((cfg, seed, device, mesh, details))
        run = {"seq": None, "starts": [0, 160], "mm": None, "robots": [], "offs": []}
        return None, "robot 0 failed to initialize", run

    monkeypatch.setattr(bench_torch, "bench_multi", bench_multi)
    ph = SimpleNamespace(launches=0, launches_by_shape=Counter())
    with pytest.raises(AssertionError, match="robot 0 failed to initialize"):
        chip_smoke.bank_path_phase(torch, ph, "cpu")
    assert [c[1] for c in calls] == list(bench_torch.MULTI_SEEDS)
    assert all(c[0] == bench_torch._cfg() and c[2:] == ("cpu", "mesh", True) for c in calls)
    assert meshes == [None, None]
