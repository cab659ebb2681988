"""Host-driven monocular session (port of the mono, loop-closing-off part of
orbslamm_tpu/models/system.py).

  * MapContext   — one map: its pools, id and keyframe count
  * RobotTracker — one robot's tracking state machine
                   {NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST}: two-view
                   initialization, then the fused per-frame step or the
                   pipelined chunk path; a young map that loses tracking is
                   reset and re-initialized
  * MonocularSession — the single-robot facade

Paths this slice does not have raise ``NotImplementedError`` naming the
ROADMAP step that brings them: a vocabulary (``vocabulary_path``, or loop
closing still on once a map holds 4 keyframes — switch it off with
``sess.enable_loop_closing = False``), relocalization after a loss,
localization mode, stereo and RGB-D.
"""

from __future__ import annotations

import enum
import math
import weakref
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from orbslamm_tpu.utils.config import SlamConfig
from orbslamm_tpu_torch.models import fused
from orbslamm_tpu_torch.models import local_mapping as lm_stage
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.models import tracking as trk
from orbslamm_tpu_torch.ops import orb as orb_ops
from orbslamm_tpu_torch.ops import ransac
from orbslamm_tpu_torch.ops.matching import _top_k
from orbslamm_tpu_torch.ops.orb import Features

_BOW = "BoW place recognition (ROADMAP queue 1, step 9)"
_LOOP = "loop closing and relocalization (ROADMAP queue 1, step 11)"
_STEREO = "stereo and RGB-D sessions (ROADMAP queue 1, step 13)"
_LOCALIZATION = "localization mode (ROADMAP queue 1, step 11)"


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to orbslamm_tpu_torch yet")


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def _create_initial_map(cfg: SlamConfig, m: ms.MapState, ref: Features, cur: Features,
                        match_idx, init: ransac.InitResult, K, frame_ref, frame_cur,
                        ts_ref, ts_cur) -> ms.MapState:
    """Two keyframes + triangulated landmarks, median-depth normalized
    (reference CreateInitialMapMonocular, Tracking.cc:685-766)."""
    dev = K.device
    z = init.points1[:, 2]
    zs = torch.sort(torch.where(init.inliers, z, torch.full_like(z, float("inf")))).values
    cnt = init.inliers.sum()
    med = zs[torch.clamp_min((cnt - 1) // 2, 0)]
    scale = 1.0 / torch.clamp_min(med, 1e-6)
    pts = init.points1 * scale
    T21 = init.T21.clone()
    T21[:3, 3] = T21[:3, 3] * scale

    Mfeat = ref.valid.shape[0]
    slots = torch.arange(Mfeat, dtype=torch.int32, device=dev)  # empty pool: slot i per feature i
    d1 = torch.linalg.norm(pts, dim=-1)
    normal = pts / torch.clamp_min(d1[:, None], 1e-9)
    dmax = d1 * cfg.orb.scale_factor ** ref.level.to(torch.float32)
    dmin = dmax / cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)
    m = ms.add_landmarks(m, slots, init.inliers, pts, ref.desc, normal, dmin, dmax, 0)

    minus1 = torch.full_like(slots, -1)
    obs_ref = torch.where(init.inliers, slots, minus1)
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    m = ms.insert_keyframe(m, 0, eye4, K, ref, obs_ref, frame_ref, ts_ref, fixed=True)
    obs_cur = ms.set_rows(minus1, match_idx, slots, init.inliers)
    return ms.insert_keyframe(m, 1, T21, K, cur, obs_cur, frame_cur, ts_cur)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _truncate_init(ref: Features, cur: Features, match_idx, points1, inliers, m_out: int):
    """Reduce an oversized init extraction to the map's per-frame capacity,
    keeping ALL two-view inliers first and back-filling by response.
    Returns (ref', cur', match_idx', points1', inliers') of size m_out."""
    Mi = ref.valid.shape[0]
    dev = points1.device

    def take(f: Features, idx) -> Features:
        return Features(*(a[idx] if a is not None else None for a in f))

    neg = torch.full_like(ref.response, -1e9)
    key_r = torch.where(inliers & ref.valid, 1e6 + ref.response,
                        torch.where(ref.valid, ref.response, neg))
    _, idx_r = _top_k(key_r, m_out)
    inl2 = inliers[idx_r]
    pts2 = points1[idx_r]
    ref2 = take(ref, idx_r)
    partner = ms.mark(Mi, match_idx[idx_r], inl2)
    key_c = torch.where(partner, 1e6 + cur.response,
                        torch.where(cur.valid, cur.response, neg))
    _, idx_c = _top_k(key_c, m_out)
    cur2 = take(cur, idx_c)
    inv = torch.full((Mi,), m_out, dtype=torch.int32, device=dev)
    inv[idx_c] = torch.arange(m_out, dtype=torch.int32, device=dev)
    idx2 = inv[match_idx[idx_r]]
    inl2 = inl2 & (idx2 < m_out)
    return ref2, cur2, torch.clamp_max(idx2, m_out - 1), pts2, inl2


@dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    T_cw: np.ndarray  # absolute pose frozen at record time (fallback)
    state: str
    n_inliers: int
    map_id: int = 0
    # reference-keyframe decomposition: the export pose is T_rel @ the
    # current pose of keyframe ref_slot (-1 = none, use the frozen T_cw)
    ref_slot: int = -1
    T_rel: np.ndarray | None = None


def resolve_frame_poses(frames) -> list[np.ndarray]:
    """Export-time pose recovery through reference keyframes (System.cc:
    470-499): T_rel @ current kf_pose[ref_slot] while that keyframe is
    still valid, else the frozen absolute pose."""
    by_map: dict[int, list[int]] = {}
    for i, f in enumerate(frames):
        by_map.setdefault(f.map_id, []).append(i)
    out: list[np.ndarray] = [f.T_cw for f in frames]
    for mid, idxs in by_map.items():
        mc = MapContext.registry().get(mid)
        if mc is None:
            continue
        kf_pose = kf_valid = None
        for i in idxs:
            f = frames[i]
            if f.state != "OK" or f.T_rel is None or f.ref_slot < 0:
                continue
            if f.ref_slot >= mc.n_kf:
                continue
            if kf_pose is None:  # one fetch per map
                kf_pose = mc.map.kf_pose.cpu().numpy()
                kf_valid = mc.map.kf_valid.cpu().numpy()
            if not kf_valid[f.ref_slot]:
                continue  # culled reference keyframe -> frozen fallback
            out[i] = np.asarray(f.T_rel) @ kf_pose[f.ref_slot]
    return out


class MapContext:
    """One map (its pools and id); no keyframe database in this slice."""

    _next_id = 0
    _registry: weakref.WeakValueDictionary | None = None

    @classmethod
    def registry(cls) -> weakref.WeakValueDictionary:
        if cls._registry is None:
            cls._registry = weakref.WeakValueDictionary()
        return cls._registry

    def __init__(self, cfg: SlamConfig, *, device):
        if cfg.vocabulary_path:
            raise _not_ported(_BOW)
        self.cfg = cfg
        self.device = torch.device(device)
        self.map = ms.empty_map(cfg, device=self.device)
        self.n_kf = 0
        self.map_id = MapContext._next_id
        MapContext._next_id += 1
        MapContext.registry()[self.map_id] = self
        self.loop_closing_enabled = True

    def renew_id(self):
        """A young-map reset discards the map's content: records of the old
        generation must not resolve against the new one."""
        MapContext.registry().pop(self.map_id, None)
        self.map_id = MapContext._next_id
        MapContext._next_id += 1
        MapContext.registry()[self.map_id] = self


class RobotTracker:
    """Per-robot frame-to-frame tracking state (Tracking.cc analog)."""

    def __init__(self, cfg: SlamConfig, mapctx: MapContext, name: str = "robot0", *,
                 device):
        if cfg.sensor != "mono":
            raise _not_ported(_STEREO)
        self.cfg = cfg
        self.name = name
        self.device = torch.device(device)
        self.mapctx = mapctx
        self.state = TrackingState.NO_IMAGES_YET
        self.frames: list[FrameRecord] = []
        self.K = torch.as_tensor(cfg.camera.K(), device=self.device)
        if cfg.orb.init_features:
            # explicit init budget — may exceed the map's per-frame capacity;
            # _try_initialize truncates back to max_keypoints
            n2 = cfg.orb.init_features
            cap2 = max(cfg.orb.max_keypoints, _pow2_at_least(n2))
        else:
            n2 = min(2 * cfg.orb.n_features, cfg.orb.max_keypoints)
            cap2 = cfg.orb.max_keypoints
        self.extract = orb_ops.make_extractor(cfg.orb, cfg.camera, device=self.device)
        self.extract_init = orb_ops.make_extractor(
            cfg.orb, cfg.camera, n_features=n2, max_keypoints=cap2, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(zlib.crc32(name.encode()))
        self._reset_tracking()
        self.frame_id = -1
        self._frame_step = fused.make_frame_step(cfg, self.extract, self.K)
        self._ts = None  # device TrackState while the fused path is active
        self.chunk_size = 8
        self._chunk_step = fused.make_chunk_step(cfg, self.extract, self.K)

    def _reset_tracking(self):
        # generation counter: a host-side reset/switch makes chunks
        # dispatched earlier stale (see _finish_chunk)
        self._gen = getattr(self, "_gen", 0) + 1
        self._ref = None
        self._ref_meta = (0, 0.0)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.T_cw = eye
        self.velocity = eye
        self.last_feats = None
        self.last_lm = None
        self.last_T = eye
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self.peak_inliers_since_kf = 0
        self.prev_inliers = 0  # collapse-gate reference (0 disables the gate)
        self._last_ref = (-1, None)  # (ref_slot, T_rel) of the latest frame

    def switch_map(self, mapctx: MapContext):
        """Point the tracker at a (new or reset) map."""
        self.mapctx = mapctx
        self.state = TrackingState.NOT_INITIALIZED
        self._reset_tracking()
        self._ts = None

    def _maybe_reset_young_map(self):
        """Early-loss reset (Tracking.cc:520-528): discard a young map that
        lost tracking right after initialization and re-initialize."""
        if (self.state == TrackingState.LOST
                and self.mapctx.n_kf < self.cfg.tracking.min_kfs_for_new_map):
            mc = self.mapctx
            mc.map = ms.empty_map(self.cfg, device=self.device)
            mc.n_kf = 0
            mc.renew_id()
            self.switch_map(mc)

    def _sync_from_ts(self):
        """Copy the device TrackState back into the host-path fields."""
        if self._ts is None:
            return
        t = self._ts
        self.T_cw = t.T_cw
        self.velocity = t.velocity
        self.last_T = t.last_T
        self.last_feats = t.last_feats
        self.last_lm = t.last_lm
        self.frames_since_kf = int(t.frames_since_kf)
        self.peak_inliers_since_kf = int(t.peak_inliers)
        self.prev_inliers = int(t.prev_inliers)
        self._ts = None

    def _empty_feats(self) -> Features:
        """All-invalid stand-in when no frame has been tracked yet."""
        M = self.cfg.orb.max_keypoints
        kw = dict(device=self.device)
        return Features(
            xy=torch.zeros((M, 2), dtype=torch.float32, **kw),
            xy_raw=torch.zeros((M, 2), dtype=torch.float32, **kw),
            angle=torch.zeros(M, dtype=torch.float32, **kw),
            response=torch.zeros(M, dtype=torch.float32, **kw),
            level=torch.zeros(M, dtype=torch.int32, **kw),
            desc=torch.zeros((M, 32), dtype=torch.uint8, **kw),
            valid=torch.zeros(M, dtype=torch.bool, **kw),
        )

    def _make_ts(self) -> fused.TrackState:
        if self.last_feats is None:
            self.last_feats = self._empty_feats()
            self.last_lm = torch.full((self.cfg.orb.max_keypoints,), -1,
                                      dtype=torch.int32, device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        mc = self.mapctx
        return fused.TrackState(
            T_cw=self.T_cw,
            velocity=self.velocity,
            last_T=self.last_T,
            last_feats=self.last_feats,
            last_lm=self.last_lm,
            frames_since_kf=torch.tensor(self.frames_since_kf, **i32),
            peak_inliers=torch.tensor(self.peak_inliers_since_kf, **i32),
            prev_inliers=torch.tensor(self.prev_inliers, **i32),
            n_kf=torch.tensor(mc.n_kf, **i32),
            lost=torch.tensor(False, device=self.device),
            # rebuilt only here (host events); the fused step maintains it
            obs_ind=ms.lm_indicator(mc.map),
            last_kf_T=mc.map.kf_pose[max(mc.n_kf - 1, 0)],
        )

    def _check_loop_closing_off(self):
        """The JAX package first needs a vocabulary here (it trains one once
        a map holds 4 keyframes and loop closing is on)."""
        if self.mapctx.loop_closing_enabled and self.mapctx.n_kf >= 4:
            raise _not_ported(_BOW + " and " + _LOOP)

    # -- initialization ----------------------------------------------------
    def _try_initialize(self, feats: Features, timestamp: float):
        cfg = self.cfg
        if self._ref is None:
            self._ref = feats
            self._ref_meta = (self.frame_id, timestamp)
            return
        res = trk.match_for_init(cfg, self._ref, feats)
        n = int(res.ok.sum())
        if n < cfg.tracking.min_matches_init:
            # drop the reference only when matching has clearly broken down
            if n < int(0.6 * cfg.tracking.min_matches_init):
                self._ref = feats
                self._ref_meta = (self.frame_id, timestamp)
            return
        xy_cur = feats.xy[res.idx]
        init = None
        # a second independent draw for borderline two-view problems
        for _attempt in range(2):
            init = ransac.two_view_init(
                self._ref.xy, xy_cur, res.ok, self.K, self.generator, n_hyp=512,
                sigma=1.5, min_inliers=cfg.tracking.init_min_triangulated,
                median_parallax_cos=math.cos(math.radians(cfg.tracking.init_min_parallax_deg)),
            )
            if bool(init.success):
                break
        if not bool(init.success):
            return
        mc = self.mapctx
        ref_f, cur_f, match_idx = self._ref, feats, res.idx
        if ref_f.valid.shape[0] > cfg.orb.max_keypoints:
            ref_f, cur_f, match_idx, pts2, inl2 = _truncate_init(
                ref_f, cur_f, match_idx, init.points1, init.inliers, cfg.orb.max_keypoints)
            init = init._replace(points1=pts2, inliers=inl2)
            feats = cur_f
        mc.map = _create_initial_map(cfg, mc.map, ref_f, cur_f, match_idx, init, self.K,
                                     self._ref_meta[0], self.frame_id, self._ref_meta[1],
                                     timestamp)
        mc.n_kf = 2
        mc.map = lm_stage.local_bundle_adjustment(cfg, mc.map, 1, window=2, iters=20)
        self.T_cw = mc.map.kf_pose[1]
        self.last_T = self.T_cw
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self.last_feats = feats
        self.last_lm = mc.map.kf_obs_lm[1]
        self.last_kf_inliers = int(init.n_inliers)
        self.peak_inliers_since_kf = int(init.n_inliers)
        self.prev_inliers = 0
        self.state = TrackingState.OK
        self.frames_since_kf = 0
        self._last_ref = (1, np.eye(4))  # this frame IS keyframe 1

    # -- tracking ----------------------------------------------------------
    def _track_fused(self, img, timestamp: float) -> int:
        mc = self.mapctx
        if self._ts is None:
            self._ts = self._make_ts()
        m, ts_next, summary = self._frame_step(mc.map, self._ts, img, self.frame_id,
                                               timestamp)
        mc.map = m
        self._ts = ts_next
        s = fused.FrameSummary(*(x.cpu().numpy() for x in summary))
        n_inl = int(s.n_inliers)
        self.T_cw = torch.as_tensor(s.T_cw, device=self.device)
        if not bool(s.tracking_ok):
            self._last_ref = (-1, None)
            self._sync_from_ts()
            return 0  # tracking failure regardless of the raw inlier count
        self._last_ref = (int(s.ref_slot), np.asarray(s.T_rel))
        if bool(s.new_kf):
            mc.n_kf = int(s.kf_slot) + 1
        return n_inl

    def _try_relocalize(self, feats: Features) -> int:
        raise _not_ported(_LOOP)

    # -- chunked streaming path ---------------------------------------------
    def process_frames(self, images, timestamps) -> list[FrameRecord]:
        """Process a batch of frames through the chunk path, chunk k+1
        dispatched before chunk k's summaries are read; initialization and
        loss frames take the per-frame path."""
        recs: list[FrameRecord] = []
        pending = None
        i, n = 0, len(timestamps)
        while i < n:
            cs = self.chunk_size
            if self.state == TrackingState.OK and n - i >= cs:
                tok = self._dispatch_chunk(images[i:i + cs], timestamps[i:i + cs])
                i += cs
                if pending is not None:
                    recs.extend(self._finish_chunk(pending))
                pending = tok
            else:
                if pending is not None:
                    recs.extend(self._finish_chunk(pending))
                    pending = None
                    continue  # state may have changed — re-evaluate
                recs.append(self.process_frame(images[i], float(timestamps[i])))
                i += 1
        if pending is not None:
            recs.extend(self._finish_chunk(pending))
        return recs

    def _dispatch_chunk(self, images, timestamps) -> dict:
        """Run one chunk through the chunk step. Returns a token for
        ``_finish_chunk``."""
        self._check_loop_closing_off()
        mc = self.mapctx
        cs = len(timestamps)
        if self._ts is None:
            self._ts = self._make_ts()
        fids = list(range(self.frame_id + 1, self.frame_id + 1 + cs))
        stamps = [float(t) for t in np.asarray(timestamps, np.float32)]
        m, ts, summaries = self._chunk_step(mc.map, self._ts, images, fids, stamps)
        mc.map = m
        self._ts = ts
        fid0 = self.frame_id + 1
        self.frame_id += cs
        return {"mc": mc, "summaries": summaries,
                "timestamps": [float(t) for t in timestamps], "fid0": fid0,
                "gen": self._gen}

    def _finish_chunk(self, token: dict) -> list[FrameRecord]:
        """Read a chunk's summaries and write its frame records."""
        mc: MapContext = token["mc"]
        timestamps = token["timestamps"]
        s = fused.FrameSummary(*(x.cpu().numpy() for x in token["summaries"]))
        # a chunk dispatched before a reset is stale: emit its records but
        # leave the tracker's new state machine alone
        stale = token["gen"] != self._gen or self.mapctx is not mc
        recs: list[FrameRecord] = []
        last_T = self.T_cw.cpu().numpy() if torch.is_tensor(self.T_cw) else self.T_cw
        for j in range(len(timestamps)):
            ok = bool(s.tracking_ok[j])
            if ok:
                last_T = np.asarray(s.T_cw[j])
                if not stale:
                    self.T_cw = torch.as_tensor(last_T, device=self.device)
                if bool(s.new_kf[j]):
                    mc.n_kf = max(mc.n_kf, int(s.kf_slot[j]) + 1)
            elif not stale:
                self.state = TrackingState.LOST
            rec = FrameRecord(
                frame_id=token["fid0"] + j,
                timestamp=float(timestamps[j]),
                T_cw=last_T,
                state=("OK" if ok else "LOST") if stale else self.state.name,
                n_inliers=int(s.n_inliers[j]) if ok else 0,
                map_id=mc.map_id,
                ref_slot=int(s.ref_slot[j]) if ok else -1,
                T_rel=np.asarray(s.T_rel[j]) if ok else None,
            )
            self.frames.append(rec)
            recs.append(rec)
        if not stale:
            self._maybe_reset_young_map()
        return recs

    # -- public API --------------------------------------------------------
    def process_frame(self, image, timestamp: float) -> FrameRecord:
        self._check_loop_closing_off()
        self.frame_id += 1
        img = torch.as_tensor(image, device=self.device)
        n_inl = 0
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            feats = self.extract_init(img)
            self.state = TrackingState.NOT_INITIALIZED
            self._try_initialize(feats, timestamp)
        elif self.state == TrackingState.OK:
            n_inl = self._track_fused(img, timestamp)
            if n_inl < self.cfg.tracking.min_inliers_local_map:
                self.state = TrackingState.LOST
                self._maybe_reset_young_map()
        else:
            self._try_relocalize(self.extract(img))
        ok_now = self.state == TrackingState.OK
        rec = FrameRecord(
            frame_id=self.frame_id,
            timestamp=timestamp,
            T_cw=self.T_cw.cpu().numpy(),
            state=self.state.name,
            n_inliers=n_inl,
            map_id=self.mapctx.map_id,
            ref_slot=self._last_ref[0] if ok_now else -1,
            T_rel=self._last_ref[1] if ok_now else None,
        )
        self.frames.append(rec)
        return rec


@dataclass
class MonocularSession:
    """Single-robot single-map facade (System analog)."""

    cfg: SlamConfig
    name: str = "robot0"
    device: str | torch.device = field(kw_only=True)  # always named by the caller

    def __post_init__(self):
        self.mapctx = MapContext(self.cfg, device=self.device)
        self.tracker = RobotTracker(self.cfg, self.mapctx, self.name, device=self.device)

    @property
    def enable_loop_closing(self) -> bool:
        return self.tracker.mapctx.loop_closing_enabled

    @enable_loop_closing.setter
    def enable_loop_closing(self, on: bool):
        self.tracker.mapctx.loop_closing_enabled = bool(on)

    # -- passthroughs ------------------------------------------------------
    @property
    def map(self):
        return self.tracker.mapctx.map

    @property
    def n_kf(self):
        return self.tracker.mapctx.n_kf

    @property
    def state(self):
        return self.tracker.state

    @property
    def frames(self):
        return self.tracker.frames

    @property
    def T_cw(self):
        return self.tracker.T_cw

    def activate_localization_mode(self):
        raise _not_ported(_LOCALIZATION)

    def process_frame(self, image, timestamp):
        return self.tracker.process_frame(image, timestamp)

    def process_frames(self, images, timestamps):
        """Chunked streaming (see RobotTracker.process_frames)."""
        return self.tracker.process_frames(images, timestamps)

    def keyframe_trajectory(self):
        m = self.map
        valid = m.kf_valid.cpu().numpy()
        poses = m.kf_pose.cpu().numpy()[valid]
        stamps = m.kf_timestamp.cpu().numpy()[valid]
        order = np.argsort(m.kf_frame_id.cpu().numpy()[valid])
        return stamps[order], poses[order]

    def frame_trajectory(self):
        """OK-frame trajectory, poses resolved through reference keyframes."""
        ok = [f for f in self.frames if f.state == "OK"]
        stamps = np.array([f.timestamp for f in ok])
        poses = np.stack(resolve_frame_poses(ok)) if stamps.size else np.zeros((0, 4, 4))
        return stamps, poses
