"""Where the port's distributed parts meet the limits of float order and of
the cross-process scan, on the card; no asserts of its own, one
``dist_diag`` JSON line per comparison.

    python3 tools/dist_diag.py gba
    python3 tools/dist_diag.py multihost span
    python3 tools/dist_diag.py multihost merge
    python3 tools/dist_diag.py bank cpu cuda:0,cpu

``bank`` runs the merge scenario of tests/test_torch_streams_session.py
(320x240, two robots, one MultiMapper) with the trackers on the device its
first argument names and the bank's mesh over the slots its second names
(``none``: no mesh), and prints one line per chunk (the records it
returned, the bank's events, generations and followers, the robots' states)
and one for the run. The other modes first run chip_smoke.py's multi-map phase (bench.py's two-robot
scenario, about 2 minutes on an H100). ``gba`` then runs the global BA of
its merged map (chip_smoke's GBA_ITERS x GBA_CG_ITERS, every observation
slot) and compares solutions: two runs of the unsharded call on the card,
the 1- and 4-slot keyframe-sharded calls against it, 4 slots against 1 on
the CPU, and the CPU's unsharded call against the card's; per comparison
chip_smoke's ``gba_agreement`` (cost, poses, keyframe ATE, reprojections,
landmarks) and the five landmarks that moved most (observations, parallax
between their keyframes). ``multihost`` runs chip_smoke's multihost
phase from the robots' maps as they stood at the start of the span in which
the multi-map phase merged (``span``) or when the merge was applied
(``merge``, the smoke's hand-off); its gates apply, so ``span`` exits non-zero
when no process merges, after the phase's line.
"""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _landmark_report(torch, cfg, m, got, want, tag):
    """The comparison line of two global-BA solutions of map ``m``:
    chip_smoke's ``gba_agreement``, and the five landmarks that moved most
    with their observation counts and the parallax between the keyframes
    that observe them."""
    obs = m.kf_obs_lm
    ok = (obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    k, f = torch.nonzero(ok, as_tuple=True)
    lm = obs[k, f].long()
    lv = m.lm_valid
    dl = (got.lm_pos - want.lm_pos).norm(dim=1)
    centres = -(m.kf_pose[:, :3, :3].transpose(1, 2) @ m.kf_pose[:, :3, 3:])[..., 0]
    worst = []
    for w in torch.argsort(torch.where(lv, dl, torch.zeros_like(dl)), descending=True)[:5].tolist():
        sel = lm == w
        rays = m.lm_pos[w][None] - centres[k[sel]]
        rays = rays / rays.norm(dim=1, keepdim=True)
        cos = float((rays @ rays.T).min()) if int(sel.sum()) > 1 else 1.0
        worst.append({"landmark": w, "diff_m": float(dl[w]), "observations": int(sel.sum()),
                      "parallax_deg": float(np.degrees(np.arccos(min(1.0, cos))))})
    out = {"tag": tag, **cs.gba_agreement(torch, cfg, m, got, want), "worst": worst}
    print("dist_diag " + json.dumps(out), flush=True)


def gba(torch, ph):
    from orbslamm_tpu_torch.models import loop_closing as lc
    from orbslamm_tpu_torch.parallel import dist_ba
    from orbslamm_tpu_torch.parallel.multihost import stream_mesh

    _, _, handoff = cs.multimap_path_phase(torch, ph, "cuda")
    m = handoff["merged_map"]
    cfg = cs.multimap_cfg()
    kw = dict(iters=cs.GBA_ITERS, cg_iters=cs.GBA_CG_ITERS)
    M = m.kf_obs_lm.shape[1]

    def sharded(mm, devs):
        mesh = stream_mesh(devs)
        return dist_ba.gather_map_kf_blocks(
            dist_ba.make_kf_sharded_gba(mesh, cfg, **kw)(dist_ba.shard_map_kf_blocks(mm, mesh)),
            devs[0])

    ref, _ = lc.global_bundle_adjust(cfg, m, obs_per_kf=M, **kw)
    again, _ = lc.global_bundle_adjust(cfg, m, obs_per_kf=M, **kw)
    _landmark_report(torch, cfg, m, again, ref, "card: unsharded, second run")
    for n in (1, cs.DIST_SLOTS):
        _landmark_report(torch, cfg, m, sharded(m, ["cuda:0"] * n), ref, f"card: {n} slots")
    m_cpu = type(m)(*(x.cpu() for x in m))
    ref_cpu, _ = lc.global_bundle_adjust(cfg, m_cpu, obs_per_kf=M, **kw)
    _landmark_report(torch, cfg, m_cpu, sharded(m_cpu, ["cpu"] * cs.DIST_SLOTS), ref_cpu,
                     f"cpu: {cs.DIST_SLOTS} slots")
    _landmark_report(torch, cfg, m, type(m)(*(x.cuda() for x in ref_cpu)), ref, "cpu unsharded")


def multihost(torch, ph, when):
    from orbslamm_tpu_torch.parallel.multihost_mapper import HostMapperBridge

    spans = []  # each span's starting maps: (map_id, n_kf, map, kf_bow) per robot
    stream_span = cs._stream_span

    def hooked(mm, k, *args):
        if k == 0:
            spans.append([(t.mapctx.map_id, t.mapctx.n_kf,
                           type(t.mapctx.map)(*(x.clone() for x in t.mapctx.map)),
                           t.mapctx.kf_bow.clone()) for t in mm.robots])
        return stream_span(mm, k, *args)

    cs._stream_span = hooked
    mm_result, _, handoff = cs.multimap_path_phase(torch, ph, "cuda")
    if when == "span":
        bridge = HostMapperBridge(SimpleNamespace(maps=[], robots=[]))
        handoff["payloads"] = [
            bridge._pack_map(SimpleNamespace(map_id=mid, n_kf=n_kf, map=mp, kf_bow=b))
            for mid, n_kf, mp, b in spans[-1]]
        print("dist_diag " + json.dumps({"hand_off": "span start", "n_kf": [
            n for _, n, _, _ in spans[-1]]}), flush=True)
    cs.multihost_path_phase(torch, handoff, mm_result)


def bank(torch, tracker_device, slots):
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_streams_session as sc
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.parallel.multihost import stream_mesh
    from orbslamm_tpu_torch.parallel.streams import StreamBank

    seq = sc.make_sequence(n_frames=sc.N_TOTAL, n_points=2500, cam=sc.CAM, seed=21,
                           motion="strafe")
    mm = MultiMapper(sc.CFG, device=tracker_device)
    start = sc._robots(mm, seq, ("r0", "r1"))
    bk = StreamBank(sc.CFG, mm.robots, device=tracker_device, chunk_size=sc.CHUNK,
                    mesh=None if slots == "none" else stream_mesh(slots.split(",")))
    bk.on_lost = lambda t: mm._handle_loss(t, 0.0)
    bk.on_chunk_end = mm.pump_merge_scans
    for i in range(start, sc.HALF - sc.CHUNK + 1, sc.CHUNK):
        recs = bk.process_chunk(*sc._chunk(seq, 2, i))
        print("dist_diag " + json.dumps({
            "chunk_at": i, "records": [[(f.frame_id, f.state, f.n_inliers) for f in rr]
                                       for rr in recs],
            "events": [n for n, _ in bk.events], "gens": bk._gens,
            "followers": bk.followers, "states": [t.state.name for t in mm.robots]}),
            flush=True)
    bk.sync_to_trackers()
    mm.flush_merge_scans()
    print("dist_diag " + json.dumps({
        "trackers": tracker_device, "slots": slots, "start": start,
        "merges": [[str(x) for x in mg] for mg in mm.merges],
        "events": [n for n, _ in bk.events],
        "robots": [{"states": "".join(f.state[0] for f in t.frames),
                    "inliers": [f.n_inliers for f in t.frames]} for t in mm.robots]}),
        flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dist_diag: needs a CUDA device", file=sys.stderr)
        return 2
    import orbslamm_tpu_torch  # noqa: F401
    from orbslamm_tpu_torch.ops.cuda import hamming as ph

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    ph.build()
    if sys.argv[1] == "gba":
        gba(torch, ph)
    elif sys.argv[1] == "bank":
        bank(torch, sys.argv[2], sys.argv[3])
    else:
        multihost(torch, ph, sys.argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
