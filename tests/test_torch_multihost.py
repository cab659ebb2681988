"""The port's multi-process coordination (orbslamm_tpu_torch/parallel/
multihost.py) and cross-process MultiMapper bridge (parallel/
multihost_mapper.py) on the CPU: two processes joined over gloo through the
port's own ``initialize``, a free localhost port as the coordinator.

One pair of worker processes (a fresh interpreter each, the port alone
imported) runs every collective: the ``all_gather_bytes`` round trip and
its ``ValueError``, ``broadcast_pytree`` of the vocabulary and ``barrier``,
then two ``HostMapperBridge.exchange`` rounds on fabricated maps with BoW
rows (process 0's map an orphan, process 1's tracked by a robot). The tests
read the workers' JSON reports. The full cross-process merge runs on the
card (chip_smoke.py's multihost phase), as the JAX package keeps its own
(tests/test_multihost_merge.py) among the slow tests. The helpers' single-
process behaviour, the meshes and the signature codec run in this process;
the codec against the JAX package's exactly.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslamm_tpu.parallel import multihost as jmh
from orbslamm_tpu.parallel import multihost_mapper as jmm
from orbslamm_tpu_torch.parallel import multihost as mh
from orbslamm_tpu_torch.parallel import multihost_mapper as tmm

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 240

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from orbslamm_tpu_torch import convert
    from orbslamm_tpu_torch.io.synthetic import fabricate_map, make_landmark_field
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.ops import bow
    from orbslamm_tpu_torch.parallel import multihost as mh
    from orbslamm_tpu_torch.parallel.multihost_mapper import HostMapperBridge
    from orbslamm_tpu_torch.utils.config import (CameraConfig, CapacityConfig, OrbConfig,
                                                 SlamConfig)

    pid, port, vocab = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mh.initialize(f"localhost:{port}", 2, pid, timeout_s=120)
    out = {"index": mh.process_index(), "count": mh.process_count()}
    out["gathered"] = [b.decode() for b in mh.all_gather_bytes(f"merge:map{pid}".encode() * (pid + 1))]
    try:
        mh.all_gather_bytes(b"x" * 100, max_len=10)
        out["too_long"] = "no error"
    except ValueError as e:
        out["too_long"] = str(e)
    voc_np = convert.vocabulary_to_numpy(bow.load_vocabulary_npz(vocab, device="cpu")) \\
        if pid == 0 else None
    voc_np = mh.broadcast_pytree(voc_np, max_len=1 << 20)
    voc = convert.vocabulary_from_numpy(voc_np, device="cpu")
    out["voc"] = [voc.n_words, float(voc.idf.sum()), int(voc.nodes.sum())]
    mh.barrier()

    cam = CameraConfig(width=160, height=120, fx=130, fy=130, cx=80, cy=60)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=120, max_keypoints=256, n_levels=2),
                     capacity=CapacityConfig(max_keyframes=16, max_landmarks=512))
    mm = MultiMapper(cfg, device="cpu")
    mm.voc = voc
    # process 1's map is tracked by a robot (shipped as a copy); process 0's
    # is an orphan (migrates)
    mc = mm.add_robot("r1").mapctx if pid == 1 else mm.new_map()
    pts = make_landmark_field(400, extent=4.0, depth_range=(3.0, 7.0), seed=4)
    desc = np.random.default_rng(4).integers(0, 256, (len(pts), 32), dtype=np.uint8)
    n = 12
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = -0.1 * np.arange(n) - 0.3 * pid
    mc.map, _ = fabricate_map(cfg, poses, pts, desc, seed=10 + pid, device="cpu")
    mc.n_kf = n
    mc.kf_bow = bow.update_bow_rows(voc, mc.map.kf_desc, mc.map.kf_feat_valid,
                                    torch.zeros((16, voc.n_words)), list(range(n)))
    out["local_map_id"] = mc.map_id
    bridge = HostMapperBridge(mm)
    out["signatures"] = [s["map_id"] for s in bridge._local_signatures()]
    out["imported_round"] = [bridge.exchange(), bridge.exchange()]
    out["imported"] = sorted(list(k) for k in bridge._imported)
    out["transfers"] = bridge.transfers
    out["events"] = [e for e, _ in bridge.events]
    out["live"] = sorted(m.map_id for m in mm.live_maps())
    got = next(m for m in mm.maps if m.map_id not in (mc.map_id,) and m.n_kf == n)
    out["imported_map"] = {"map_id": got.map_id, "n_kf": got.n_kf,
                           "device": str(got.map.kf_pose.device),
                           "kf_valid": int(got.map.kf_valid.sum()),
                           "bow_rows": int((got.kf_bow.sum(-1) > 0).sum())}
    out["queued"] = {str(k): v for k, v in mm._scan_queue.items()}
    mh.barrier()
    print("REPORT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    return env


@pytest.fixture(scope="module")
def reports():
    port = _free_port()
    vocab = REPO / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(i), str(port), str(vocab)],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.loads(next(line for line in out.splitlines()
                            if line.startswith("REPORT "))[7:]) for out in outs]


def test_all_gather_bytes_round_trip_and_limit(reports):
    for pid, r in enumerate(reports):
        assert (r["index"], r["count"]) == (pid, 2)
        assert r["gathered"] == ["merge:map0", "merge:map1merge:map1"]
        assert r["too_long"] == "payload 100 > max_len 10"


def test_broadcast_pytree_and_barrier(reports):
    """Process 0's vocabulary reaches process 1 whole (both passed the
    barriers that follow)."""
    from orbslamm_tpu_torch.ops import bow
    voc = bow.load_vocabulary_npz(REPO / "orbslamm_tpu" / "data" / "vocab_10x4.npz",
                                  device="cpu")
    want = [voc.n_words, float(voc.idf.sum()), int(voc.nodes.sum())]
    assert reports[0]["voc"] == reports[1]["voc"] == want


def test_bridge_exchange_imports_each_map_once(reports):
    """Each process announces its map, scores the other's signature against
    its own database, requests it and imports it once, on its own device,
    with its BoW rows, and queues its newest keyframes for the merge scan;
    the second round imports nothing. Process 0's orphan migrated and is
    retired; process 1's tracked map was shipped as a copy and stays live."""
    r0, r1 = reports
    for pid, r in enumerate(reports):
        other = reports[1 - pid]
        assert r["signatures"] == [r["local_map_id"]]
        assert r["imported_round"] == [1, 0]
        assert r["imported"] == [[1 - pid, other["local_map_id"]]]
        im = r["imported_map"]
        assert (im["n_kf"], im["kf_valid"], im["bow_rows"], im["device"]) == (12, 12, 12, "cpu")
        assert r["queued"] and all(0 <= s < 12 for s in r["queued"][str(im["map_id"])])
        assert r["events"][0] == "multihost_map_received"
    assert r0["transfers"] == [{"map_id": r0["local_map_id"], "tracked": False}]
    assert r0["events"][1:] == ["multihost_map_migrated"]
    assert r0["live"] == [r0["imported_map"]["map_id"]]  # the orphan retired
    assert r1["transfers"] == [{"map_id": r1["local_map_id"], "tracked": True}]
    assert r1["events"][1:] == ["multihost_map_copied"]
    assert r1["live"] == sorted([r1["local_map_id"], r1["imported_map"]["map_id"]])


def test_single_process_helpers(monkeypatch):
    """No coordinator and no MASTER_ADDR / WORLD_SIZE: ``initialize`` is a
    no-op, and the collectives return their input."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    mh.initialize()
    assert not torch.distributed.is_initialized()
    assert (mh.process_index(), mh.process_count()) == (0, 1)
    mh.barrier()
    assert mh.all_gather_bytes(b"merge:map3->map0") == [b"merge:map3->map0"]
    tree = {"voc": np.arange(4), "id": 7}
    back = mh.broadcast_pytree(tree)
    assert back["id"] == 7 and (back["voc"] == np.arange(4)).all()
    with pytest.raises(ValueError, match="together"):
        mh.initialize("localhost:1", num_processes=2)


def test_initialize_raises_against_a_dead_coordinator():
    """Process 1 of 2 pointed at a port nobody serves: ``initialize``
    raises within its timeout, and the process never goes on as a single
    process."""
    script = textwrap.dedent("""
        import sys, time
        from orbslamm_tpu_torch.parallel import multihost as mh
        t0 = time.perf_counter()
        try:
            mh.initialize(f"localhost:{sys.argv[1]}", 2, 1, timeout_s=3)
        except Exception as e:
            print("RAISED", type(e).__name__, round(time.perf_counter() - t0, 1))
            sys.exit(0)
        print("CARRIED_ON", mh.process_count())
    """)
    out = subprocess.run([sys.executable, "-c", script, str(_free_port())], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("RAISED"), out.stdout


def test_meshes():
    """test_multihost.py's axes: host_mesh is (host, chip) with one row in
    a single process, stream_mesh flat over ("d",); a device list may repeat
    a device; without CUDA the default device list is refused."""
    devs = ["cpu"] * 8
    hm = mh.host_mesh(devs)
    assert hm.axis_names == ("host", "chip") and hm.devices.shape == (1, 8)
    sm = mh.stream_mesh(devs)
    assert sm.axis_names == ("d",) and sm.devices.size == len(sm) == 8
    assert sm.flat == [torch.device("cpu")] * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.stream_mesh()
    # the JAX package's meshes have the same axes
    assert jmh.host_mesh().axis_names == hm.axis_names
    assert jmh.stream_mesh().axis_names == sm.axis_names


@pytest.mark.cuda
def test_default_meshes_span_the_local_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = torch.cuda.device_count()
    assert mh.stream_mesh().flat == [torch.device("cuda", i) for i in range(n)]
    assert mh.host_mesh().devices.shape == (1, n)


@pytest.mark.parametrize("top_w", [1, 8, 64])
def test_signature_codec_matches_jax(top_w):
    """_sparsify_rows / _densify_rows equal the JAX package's on one input
    (with tied weights, where argsort's order decides)."""
    rng = np.random.default_rng(top_w)
    rows = rng.random((6, 1000)).astype(np.float32)
    rows[:, 10:20] = 0.5  # ties
    rows[rows < 0.7] = 0.0
    idx_t, w_t = tmm._sparsify_rows(rows, top_w)
    idx_j, w_j = jmm._sparsify_rows(rows, top_w)
    assert np.array_equal(idx_t, idx_j) and np.array_equal(w_t, w_j)
    assert idx_t.dtype == idx_j.dtype and w_t.dtype == w_j.dtype
    assert np.array_equal(tmm._densify_rows(idx_t, w_t, 1000),
                          jmm._densify_rows(idx_j, w_j, 1000))
