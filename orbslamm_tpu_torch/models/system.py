"""Host-driven monocular session (port of the mono part of
orbslamm_tpu/models/system.py).

  * MapContext   — one map: its pools, its keyframe BoW database (a file
                   vocabulary, or one trained from the map's descriptors),
                   loop closing (detection, Sim3 verification,
                   essential-graph correction) and the overlapped global-BA
                   schedule
  * RobotTracker — one robot's tracking state machine
                   {NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST}: two-view
                   initialization, then the fused per-frame step or the
                   pipelined chunk path; a young map that loses tracking is
                   reset, an older one relocalizes against the BoW database;
                   localization mode tracks without inserting keyframes.
                   The hooks ``on_keyframe``, ``reloc_on_loss`` and
                   ``auto_reset_young`` hand keyframe events and loss
                   handling to a MultiMapper (models/multimap.py).
                   Stereo and RGB-D frames take the host-sequenced path:
                   a one-keyframe bootstrap from depth, then ``_track``
                   (motion model, local map, keyframe decision) with
                   ``MapContext.insert_keyframe``'s stage-by-stage pipeline
  * MonocularSession, StereoSession, RGBDSession — the single-robot facades
"""

from __future__ import annotations

import enum
import math
import weakref
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.models import fused
from orbslamm_tpu_torch.models import local_mapping as lm_stage
from orbslamm_tpu_torch.models import loop_closing as lc_stage
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.models import tracking as trk
from orbslamm_tpu_torch.ops import bow
from orbslamm_tpu_torch.ops import geometry as geo
from orbslamm_tpu_torch.ops import orb as orb_ops
from orbslamm_tpu_torch.ops import ransac
from orbslamm_tpu_torch.ops import stereo as st
from orbslamm_tpu_torch.ops.matching import _top_k
from orbslamm_tpu_torch.ops.orb import Features
from orbslamm_tpu_torch.utils.trace import stage

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


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class MapContext:
    """One map: its pools, keyframe BoW database, loop closing and the
    overlapped global-BA schedule (Map + KeyFrameDatabase + LoopClosing)."""

    _next_id = 0
    _registry: weakref.WeakValueDictionary | None = None
    _voc_file_cache: dict = {}

    @classmethod
    def registry(cls) -> weakref.WeakValueDictionary:
        if cls._registry is None:
            cls._registry = weakref.WeakValueDictionary()
        return cls._registry

    def __init__(self, cfg: SlamConfig, voc: bow.Vocabulary | None = None, *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.map = ms.empty_map(cfg, device=self.device)
        self.n_kf = 0
        self.map_id = MapContext._next_id
        MapContext._next_id += 1
        MapContext.registry()[self.map_id] = self
        self.voc = voc
        self.kf_bow = None
        self.loop_closing_enabled = True
        if voc is None and cfg.vocabulary_path:
            # a file vocabulary is there from frame 0 (the reference's
            # mandatory ORBvoc.txt, System.cc:167-168)
            self.ensure_vocabulary()
        elif voc is not None:
            self._alloc_bow()
        self.last_loop_kf = -(10 ** 9)
        self.loops_closed: list = []
        # covisibility-consistency chains (LoopClosing.cc:158-217): each
        # entry is (group member set, consecutive-detection count)
        self._consist: list[tuple[set, int]] = []
        # failed Sim3 verifications back off (candidate -> slot of the last
        # failed attempt)
        self._loop_verify_cooldown: dict[int, int] = {}
        # overlapped global BA: a loop closure schedules LM slices, one per
        # chunk boundary, over the current map; each slice's cost is read
        # one slice late, and the schedule stops when it stalls
        self.gba_remaining = 0
        self.gba_max_slices = 8
        self.gba_slice_iters = 2
        self.gba_cg_iters = 16
        self._gba_last_cost = None
        self._gba_cost_pending = None
        self.gba_slices_run = 0
        self.merged_into: MapContext | None = None  # set when absorbed by a merge
        # (T_anchor_before, T_anchor_after) of the latest merge correction:
        # the robot-parallel StreamBank rebases its robots' tracking states
        # through it (parallel/streams.py, its merge adoption and refresh)
        self.last_merge_rebase = None

    def _alloc_bow(self):
        K_cap = self.map.kf_pose.shape[0]
        self.kf_bow = torch.zeros((K_cap, self.voc.n_words), dtype=torch.float32,
                                  device=self.device)

    def renew_id(self):
        """A young-map reset discards the map's content: records of the old
        generation must not resolve against the new one."""
        MapContext.registry().pop(self.map_id, None)
        self.map_id = MapContext._next_id
        MapContext._next_id += 1
        MapContext.registry()[self.map_id] = self

    # -- keyframe insertion + mapping stages ------------------------------
    def insert_keyframe(self, T_cw, K, feats: Features, feat_lm, frame_id, timestamp) -> int:
        """Insert a keyframe and run the local-mapping pipeline on it, its
        indicator built once (the host-sequenced path; the fused chunk
        carries the indicator across keyframes). A stereo/RGB-D keyframe
        first spawns its close landmarks from depth. Returns the slot."""
        cfg = self.cfg
        slot = self.n_kf
        self.map = ms.insert_keyframe(self.map, slot, T_cw, K, feats, feat_lm, frame_id,
                                      timestamp)
        self.n_kf += 1
        if feats.depth is not None:
            # Tracking::CreateNewKeyFrame, stereo branch
            self.map = lm_stage.create_depth_landmarks(cfg, self.map, slot, feats.depth)
        self.map, _ = lm_stage.process_new_keyframe_cached(cfg, self.map, slot,
                                                           ms.lm_indicator(self.map))
        return slot

    # -- BoW database -----------------------------------------------------
    @staticmethod
    def load_vocabulary_file(cfg: SlamConfig, device) -> bow.Vocabulary:
        """Load (and cache per device) the configured vocabulary file: this
        framework's .npz or DBoW2 ORBvoc.txt text."""
        path = str(cfg.vocabulary_path)
        key = (path, str(torch.device(device)))
        voc = MapContext._voc_file_cache.get(key)
        if voc is None:
            with stage("bow.load"):
                if path.endswith(".npz"):
                    voc = bow.load_vocabulary_npz(path, device=device)
                else:
                    voc = bow.load_orb_vocabulary_text(path, max_depth=cfg.loop.vocab_depth + 1,
                                                       device=device)
            MapContext._voc_file_cache[key] = voc
        return voc

    def ensure_vocabulary(self) -> bool:
        """Provide the vocabulary: load the configured file (the reference's
        ORBvoc.txt, System.cc:167-168), else train one on the device from
        the descriptors of this map's keyframes once it holds 4."""
        if self.voc is not None:
            return True
        if self.cfg.vocabulary_path:
            self.voc = MapContext.load_vocabulary_file(self.cfg, self.device)
        else:
            if self.n_kf < 4:
                return False
            kv = self.map.kf_valid
            lc = self.cfg.loop
            self.voc = bow.build_vocabulary(
                self.map.kf_desc[kv][self.map.kf_feat_valid[kv]],
                branching=lc.vocab_branching, depth=lc.vocab_depth, iters=lc.vocab_iters,
                device=self.device)
        self._alloc_bow()
        kv = self.map.kf_valid.cpu().numpy()
        self.update_bow_rows([int(s) for s in np.nonzero(kv)[0]])
        return True

    def update_bow_row(self, slot: int):
        self.update_bow_rows([slot])

    def update_bow_rows(self, slots):
        """Recompute the database rows of ``slots`` (KeyFrameDatabase::add)."""
        if self.voc is None or len(slots) == 0:
            return
        with stage("bow.update"):
            self.kf_bow = bow.update_bow_rows(self.voc, self.map.kf_desc, self.map.kf_feat_valid,
                                              self.kf_bow, slots)

    # -- same-map loop closing --------------------------------------------
    def loop_scan(self, slots) -> dict:
        """Candidate scores for a batch of new keyframes with one fetch.
        Returns {slot: (scores with -1 where inadmissible [K], min_score)}."""
        cfg = self.cfg
        if self.voc is None or not slots or self.n_kf < cfg.loop.min_kfs_for_merge:
            return {}
        with stage("loop.detect"):
            scores, allowed, min_score = lc_stage.batched_loop_candidates(
                cfg, self.map, self.kf_bow, slots, min_gap=cfg.loop.kfs_between_loops)
            sc = _np(torch.where(allowed, scores, torch.full_like(scores, -1.0)))
            msc = _np(min_score)
        return {s: (sc[i], float(msc[i])) for i, s in enumerate(slots)}

    def try_close_loop(self, slot: int, generator: torch.Generator, precomputed=None) -> bool:
        cfg = self.cfg
        if (not self.loop_closing_enabled or self.voc is None
                or self.n_kf < cfg.loop.min_kfs_for_merge
                or slot - self.last_loop_kf < cfg.loop.kfs_between_loops):
            return False
        with stage("loop.detect"):
            if precomputed is None:
                scores, allowed, min_score = lc_stage.loop_candidates(
                    cfg, self.map, self.kf_bow, slot, min_gap=cfg.loop.kfs_between_loops)
                sc = _np(torch.where(allowed, scores, torch.full_like(scores, -1.0)))
                min_score = float(min_score)
            else:
                sc, min_score = precomputed
            # minScore normalization (LoopClosing.cc:131)
            floor = max(min_score, 0.015)
            if float(sc.max()) < floor:
                self._consist = []  # no candidates: chains reset (LoopClosing.cc:152)
                return False
            # covisibility-group accumulation + top-k representatives
            # (KeyFrameDatabase.cc:129-200)
            acc_d, nb_d = lc_stage.candidate_groups(
                cfg, self.map,
                torch.as_tensor(np.where(sc >= floor, sc, -1.0).astype(np.float32),
                                device=self.device))
            acc, nb = _np(acc_d), _np(nb_d)
            cands: list[int] = []
            masked = acc.copy()
            for _ in range(cfg.loop.top_k_candidates):
                c = int(masked.argmax())
                if masked[c] <= 0:
                    break
                cands.append(int(np.argmax(np.where(nb[c], sc, -1.0))))
                masked[nb[c]] = -1.0
            # consistency over consecutive keyframes (LoopClosing.cc:158-217)
            prev = self._consist
            new_groups: list[tuple[set, int]] = []
            enough: list[int] = []
            for c in cands:
                group = set(np.nonzero(nb[c])[0].tolist())
                count = 0
                for pg, pc in prev:
                    if group & pg:
                        count = max(count, pc + 1)
                new_groups.append((group, count))
                if count >= cfg.loop.covisibility_consistency:
                    enough.append(c)
            self._consist = new_groups
        if not enough:
            return False
        return self.verify_and_correct_loop(slot, enough, generator)

    def verify_and_correct_loop(self, slot: int, candidates, generator: torch.Generator) -> bool:
        """The part of loop closing after detection: Sim3 verification of
        ``slot`` against each candidate in turn (failed ones back off for 8
        keyframes), then the essential-graph correction of the first that
        verifies, one global-BA slice and the schedule of the overlapped
        rest (LoopClosing::ComputeSim3 + CorrectLoop)."""
        cfg = self.cfg
        ls, cand = None, -1
        with stage("loop.verify"):
            for c in candidates:
                if slot - self._loop_verify_cooldown.get(c, -(10 ** 9)) < 8:
                    continue
                ls_c = lc_stage.compute_loop_sim3(cfg, self.map, slot, c, generator)
                if bool(ls_c.success):
                    ls, cand = ls_c, c
                    break
                self._loop_verify_cooldown[c] = slot
        if ls is None:
            return False
        with stage("loop.correct"):
            self.map = lc_stage.correct_loop(cfg, self.map, slot, cand, ls.S_ba)
        # one immediate slice stabilizes the seam; the rest of the global
        # BA runs overlapped, one slice per chunk boundary
        with stage("gba.slice"):
            self.map, cost = lc_stage.global_bundle_adjust(
                cfg, self.map, iters=self.gba_slice_iters, cg_iters=self.gba_cg_iters)
            self.gba_slices_run += 1
        self.schedule_gba(first_cost=float(cost))
        self.last_loop_kf = slot
        self._consist = []
        self.loops_closed.append((slot, cand, int(ls.n_inliers)))
        return True

    def schedule_gba(self, first_cost: float | None = None):
        """(Re-)schedule the overlapped global BA; re-scheduling while slices
        remain is the reference's abort-and-restart of its GBA thread."""
        self.gba_remaining = self.gba_max_slices
        self._gba_last_cost = first_cost
        self._gba_cost_pending = None

    def gba_resolve_cost(self, cost: float) -> None:
        """Stop the schedule once a slice's relative improvement stalls."""
        if self._gba_last_cost is not None and cost >= self._gba_last_cost * (1.0 - 1e-3):
            self.gba_remaining = 0
        self._gba_last_cost = cost

    def gba_slice(self) -> bool:
        """Run one overlapped global-BA slice if any is scheduled; the
        previous slice's cost is read first (one slice late). Returns True
        when a slice ran."""
        if self._gba_cost_pending is not None:
            cost = float(self._gba_cost_pending)
            self._gba_cost_pending = None
            self.gba_resolve_cost(cost)
        if self.gba_remaining <= 0:
            return False
        with stage("gba.slice"):
            self.map, self._gba_cost_pending = lc_stage.global_bundle_adjust(
                self.cfg, self.map, iters=self.gba_slice_iters, cg_iters=self.gba_cg_iters)
        self.gba_remaining -= 1
        self.gba_slices_run += 1
        return True

    def summary(self) -> dict:
        s = ms.as_numpy_summary(self.map)
        s["map_id"] = self.map_id
        return s


class RobotTracker:
    """Per-robot frame-to-frame tracking state (Tracking.cc analog)."""

    def __init__(self, cfg: SlamConfig, mapctx: MapContext, name: str = "robot0", *,
                 device):
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
        self.on_keyframe = None  # callback(tracker, slot): the MultiMapper's hook
        # set by MultiMapper.set_multi_mapping(False): a loss relocalizes
        # even though a MultiMapper owns this tracker
        self.reloc_on_loss = False
        # True while a chunk's keyframe events run: the MultiMapper hook only
        # enqueues merge scans then (its pump runs once per chunk)
        self._in_chunk_finish = False
        # localization-only mode: track against the frozen map, never insert
        # keyframes; on loss, relocalize (System::ActivateLocalizationMode)
        self.localization_only = False
        # early-loss reset of a young map (Tracking.cc:520-528); a
        # MultiMapper turns it off and handles the loss itself
        self.auto_reset_young = True
        self._frame_step = fused.make_frame_step(cfg, self.extract, self.K)
        self._ts = None  # device TrackState while the fused path is active
        self.chunk_size = 8
        # built on first use; rebuilt when the vocabulary appears (the
        # with_bow step folds the BoW row + loop scan into the chunk)
        self._chunk_step = None
        self._chunk_bow = False

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

    def adopt_merged_map(self, mapctx: MapContext, S_new_from_old: torch.Tensor, lm_remap):
        """After this robot's map was merged into ``mapctx``: keep tracking,
        with the pose and landmark associations carried into the merged map
        (``S_new_from_old`` maps the old world into the merged one)."""
        self._sync_from_ts()
        self.mapctx = mapctx
        S = geo.sim3_compose(geo.sim3_from_se3(self.T_cw), geo.sim3_inv(S_new_from_old))
        self.T_cw = geo.sim3_to_se3(S)
        self.last_T = self.T_cw
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        if self.last_lm is not None:
            remapped = lm_remap[torch.clamp_min(self.last_lm, 0).long()]
            self.last_lm = torch.where(self.last_lm >= 0, remapped,
                                       torch.full_like(self.last_lm, -1))

    def _maybe_reset_young_map(self):
        """Early-loss reset (Tracking.cc:520-528): discard a young map that
        lost tracking right after initialization and re-initialize."""
        if (self.state == TrackingState.LOST and self.auto_reset_young
                and not self.localization_only
                and self.mapctx.n_kf < self.cfg.tracking.min_kfs_for_new_map):
            mc = self.mapctx
            mc.map = ms.empty_map(self.cfg, device=self.device)
            mc.n_kf = 0
            if mc.kf_bow is not None:
                mc.kf_bow = torch.zeros_like(mc.kf_bow)
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
        """All-invalid stand-in when no frame has been tracked yet (with the
        stereo fields on a stereo/RGB-D tracker, so a tracking state keeps
        one structure)."""
        M = self.cfg.orb.max_keypoints
        kw = dict(device=self.device)
        no_depth = (torch.full((M,), -1.0, dtype=torch.float32, **kw)
                    if self.cfg.sensor != "mono" else None)
        return Features(
            xy=torch.zeros((M, 2), dtype=torch.float32, **kw),
            xy_raw=torch.zeros((M, 2), dtype=torch.float32, **kw),
            angle=torch.zeros(M, dtype=torch.float32, **kw),
            response=torch.zeros(M, dtype=torch.float32, **kw),
            level=torch.zeros(M, dtype=torch.int32, **kw),
            desc=torch.zeros((M, 32), dtype=torch.uint8, **kw),
            valid=torch.zeros(M, dtype=torch.bool, **kw),
            u_right=no_depth,
            depth=None if no_depth is None else no_depth.clone(),
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

    def _vocabulary_gate(self):
        """With loop closing on, a map of 4 keyframes needs its vocabulary
        (loaded at map creation when ``vocabulary_path`` is set)."""
        mc = self.mapctx
        if (mc.loop_closing_enabled and not self.localization_only
                and mc.voc is None and mc.n_kf >= 4):
            mc.ensure_vocabulary()

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
        mc.update_bow_rows([0, 1])

    def _try_initialize_depth(self, feats: Features, timestamp: float):
        """Stereo/RGB-D bootstrap: one keyframe, landmarks unprojected from
        every positive depth (Tracking::StereoInitialization); metric scale
        comes from the sensor, no two-view init."""
        cfg = self.cfg
        n_depth = int((feats.valid & (feats.depth > 0)).sum())
        if n_depth < cfg.tracking.min_matches_init:
            return
        mc = self.mapctx
        Mfeat = feats.valid.shape[0]
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        no_obs = torch.full((Mfeat,), -1, dtype=torch.int32, device=self.device)
        mc.map = ms.insert_keyframe(mc.map, 0, eye, self.K, feats, no_obs, self.frame_id,
                                    timestamp, fixed=True)
        mc.map = lm_stage.create_depth_landmarks(
            cfg, mc.map, 0, feats.depth, max_new=min(Mfeat, cfg.capacity.max_landmarks),
            close_only=False)
        mc.n_kf = 1
        self.T_cw = eye
        self.last_T = eye
        self.velocity = eye
        self.last_feats = feats
        self.last_lm = mc.map.kf_obs_lm[0]
        self.last_kf_inliers = n_depth
        self.peak_inliers_since_kf = n_depth
        self.prev_inliers = 0
        self.state = TrackingState.OK
        self.frames_since_kf = 0
        self._last_ref = (0, np.eye(4))  # this frame IS keyframe 0
        mc.update_bow_row(0)

    # -- relocalization ----------------------------------------------------
    def _try_relocalize(self, feats: Features) -> int:
        """Relocalization with the keyframe database's group treatment
        (KeyFrameDatabase::DetectRelocalizationCandidates): covisibility-
        group accumulation with 0.75x-of-best retention, PnP verification
        of each group's best keyframe, then projection refinement against
        the local map before accepting (Tracking.cc:1404-1560)."""
        self._sync_from_ts()
        cfg = self.cfg
        mc = self.mapctx
        if mc.voc is None or mc.kf_bow is None:
            return 0
        with stage("reloc"):
            v = bow.bow_vector(mc.voc, bow.assign_words(mc.voc, feats.desc, feats.valid))
            scores = _np(lc_stage.relocalization_candidates(cfg, mc.map, mc.kf_bow, v))
            if float(scores.max()) <= 0.01:
                return 0
            acc_d, nb_d = lc_stage.candidate_groups(
                cfg, mc.map,
                torch.as_tensor(np.where(scores > 0.01, scores, -1.0).astype(np.float32),
                                device=self.device))
            acc, nb = _np(acc_d), _np(nb_d)
            masked = acc.copy()
            for _ in range(cfg.loop.top_k_candidates):
                rep = int(masked.argmax())
                if masked[rep] <= 0:
                    break
                cand = int(np.argmax(np.where(nb[rep], scores, -1.0)))
                masked[nb[rep]] = -1.0
                ok, T, feat_lm, _n = lc_stage.relocalize_against_kf(
                    cfg, mc.map, feats, self.K, cand, self.generator)
                if not bool(ok):
                    continue
                # projection refinement (SearchByProjection + final
                # PoseOptimization, Tracking.cc:1500-1553)
                r2, mc.map = trk.track_local_map(cfg, mc.map, feats, T, self.K, feat_lm)
                n2 = int(r2.n_inliers)
                if n2 < cfg.tracking.min_inliers_local_map:
                    continue
                self.T_cw = r2.T_cw
                self.last_T = r2.T_cw
                self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
                self.last_feats = feats
                self.last_lm = r2.feat_lm
                self.state = TrackingState.OK
                self.frames_since_kf = 0
                self.peak_inliers_since_kf = n2
                self.prev_inliers = 0
                ref = mc.n_kf - 1
                self._last_ref = (ref, _np(self.T_cw @ geo.T_inv(mc.map.kf_pose[ref])))
                return n2
        return 0

    # -- tracking ----------------------------------------------------------
    def _track(self, feats: Features, timestamp: float) -> int:
        """The host-sequenced tracking step: motion model (its inlier count
        read on the host), local map, the collapse gate, then the keyframe
        decision with the peak inlier count since the last keyframe, the
        stage-by-stage keyframe pipeline, loop closing and the
        ``on_keyframe`` hook. Returns the frame's inliers (0 when the
        collapse gate rejects it)."""
        cfg = self.cfg
        mc = self.mapctx
        with stage("track.motion_model"):
            r1 = trk.track_motion_model(cfg, mc.map, feats, self.velocity @ self.last_T,
                                        self.K, self.last_feats, self.last_lm,
                                        T_last=self.last_T)
            T, feat_lm = r1.T_cw, r1.feat_lm
            if int(r1.n_inliers) < cfg.tracking.min_inliers_track:
                T, feat_lm = self.last_T, torch.full_like(r1.feat_lm, -1)
        with stage("track.local_map"):
            r2, mc.map = trk.track_local_map(cfg, mc.map, feats, T, self.K, feat_lm)
            n2, n_matches = (int(x) for x in torch.stack([r2.n_inliers, r2.n_matches]).tolist())
        if (n2 < cfg.tracking.min_inliers_local_map
                or n2 < cfg.tracking.min_track_inlier_ratio * n_matches
                or n2 < 0.25 * self.prev_inliers):
            return 0 if n2 >= cfg.tracking.min_inliers_local_map else n2
        self.prev_inliers = n2
        self.T_cw = r2.T_cw
        self.velocity = self.T_cw @ geo.T_inv(self.last_T)
        self.last_T = self.T_cw
        self.last_feats = feats
        self.last_lm = r2.feat_lm
        self.frames_since_kf += 1
        # NeedNewKeyFrame with the peak inlier count since the last
        # keyframe as the tracked-reference baseline
        self.peak_inliers_since_kf = max(self.peak_inliers_since_kf, n2)
        need = self.frames_since_kf >= cfg.tracking.new_kf_max_frames or (
            self.frames_since_kf >= 1 and n2 > 15
            and n2 < cfg.tracking.new_kf_tracked_ratio * self.peak_inliers_since_kf)
        if need and not self.localization_only and mc.n_kf < cfg.capacity.max_keyframes - 1:
            slot = mc.insert_keyframe(self.T_cw, self.K, feats, r2.feat_lm, self.frame_id,
                                      timestamp)
            self._last_ref = (slot, np.eye(4))
            self.last_kf_inliers = n2
            self.peak_inliers_since_kf = n2
            self.frames_since_kf = 0
            mc.update_bow_row(slot)
            if mc.try_close_loop(slot, self.generator):
                self.T_cw = mc.map.kf_pose[slot]
                self.last_T = self.T_cw
                self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
            if self.on_keyframe is not None:
                self.on_keyframe(self, slot)
        else:
            ref = mc.n_kf - 1
            self._last_ref = (ref, _np(self.T_cw @ geo.T_inv(mc.map.kf_pose[ref])))
        return n2

    def _track_fused(self, img, timestamp: float) -> int:
        mc = self.mapctx
        if self._ts is None:
            self._ts = self._make_ts()
        m, ts_next, summary = self._frame_step(mc.map, self._ts, img, self.frame_id,
                                               timestamp,
                                               allow_kf=not self.localization_only)
        mc.map = m
        self._ts = ts_next
        s = fused.FrameSummary(*(None if x is None else x.cpu().numpy() for x in summary))
        n_inl = int(s.n_inliers)
        self.T_cw = torch.as_tensor(s.T_cw, device=self.device)
        if not bool(s.tracking_ok):
            self._last_ref = (-1, None)
            self._sync_from_ts()
            return 0  # tracking failure regardless of the raw inlier count
        self._last_ref = (int(s.ref_slot), np.asarray(s.T_rel))
        if bool(s.new_kf):
            slot = int(s.kf_slot)
            mc.n_kf = slot + 1
            mc.update_bow_row(slot)
            if mc.try_close_loop(slot, self.generator):
                # the correction moved the map: restart the motion model there
                self._sync_from_ts()
                self.T_cw = mc.map.kf_pose[slot]
                self.last_T = self.T_cw
                self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
            if self.on_keyframe is not None:
                self.on_keyframe(self, slot)
            mc.gba_slice()
        return n_inl

    def _rebase_after_loop(self, T_old, T_new):
        """The correction moved the map under the camera: re-express the
        tracking state through the corrected keyframe (the velocity is
        relative and stays)."""
        if self._ts is not None:
            self._ts = fused.rebase_track_state(self._ts, T_old, T_new)
            # correct_loop moved landmarks: the carried indicator is rebuilt
            self._ts = self._ts._replace(obs_ind=ms.lm_indicator(self.mapctx.map))
        else:
            self.last_T = self.last_T @ geo.T_inv(T_old) @ T_new
        self.T_cw = self.T_cw @ geo.T_inv(T_old) @ T_new

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
        self._vocabulary_gate()
        mc = self.mapctx
        cs = len(timestamps)
        want_bow = mc.voc is not None and mc.kf_bow is not None
        if self._chunk_step is None or self._chunk_bow != want_bow:
            self._chunk_step = fused.make_chunk_step(self.cfg, self.extract, self.K,
                                                     with_bow=want_bow)
            self._chunk_bow = want_bow
        if self._ts is None:
            self._ts = self._make_ts()
        fids = list(range(self.frame_id + 1, self.frame_id + 1 + cs))
        stamps = [float(t) for t in np.asarray(timestamps, np.float32)]
        allow_kf = not self.localization_only
        if want_bow:
            m, ts, mc.kf_bow, summaries = self._chunk_step(
                mc.map, self._ts, mc.kf_bow, mc.voc, images, fids, stamps, allow_kf)
        else:
            m, ts, summaries = self._chunk_step(mc.map, self._ts, images, fids, stamps,
                                                allow_kf)
        mc.map = m
        self._ts = ts
        fid0 = self.frame_id + 1
        self.frame_id += cs
        return {"mc": mc, "summaries": summaries,
                "timestamps": [float(t) for t in timestamps], "fid0": fid0,
                "want_bow": want_bow, "gen": self._gen}

    def _finish_chunk(self, token: dict) -> list[FrameRecord]:
        """Read a chunk's summaries, write its frame records and run the
        keyframe-rate events (loop closing, the overlapped GBA slice)."""
        mc: MapContext = token["mc"]
        timestamps = token["timestamps"]
        s = fused.FrameSummary(*(None if x is None else x.cpu().numpy()
                                 for x in token["summaries"]))
        # a chunk dispatched before a reset is stale: emit its records but
        # leave the tracker's new state machine alone
        stale = token["gen"] != self._gen or self.mapctx is not mc
        recs: list[FrameRecord] = []
        new_kfs: list[tuple[int, int]] = []  # (slot, j)
        # pass 1: records + keyframe bookkeeping — the map knows all of the
        # chunk's keyframes before loop closing runs
        last_T = _np(self.T_cw)
        for j in range(len(timestamps)):
            ok = bool(s.tracking_ok[j])
            if ok:
                last_T = np.asarray(s.T_cw[j])
                if not stale:
                    self.T_cw = torch.as_tensor(last_T, device=self.device)
                if bool(s.new_kf[j]):
                    slot = int(s.kf_slot[j])
                    mc.n_kf = max(mc.n_kf, slot + 1)
                    new_kfs.append((slot, j))
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
        if stale:
            return recs
        self._maybe_reset_young_map()
        if token["want_bow"]:
            # BoW rows + candidate scores were computed inside the chunk
            loop_pre = {slot: (np.asarray(s.loop_scores[j]), float(s.loop_min_score[j]))
                        for slot, j in new_kfs}
        else:
            mc.update_bow_rows([slot for slot, _ in new_kfs])
            loop_pre = mc.loop_scan([slot for slot, _ in new_kfs])
        # pass 2: loop closing and the MultiMapper's hook per new keyframe
        loop_rebase = None
        self._in_chunk_finish = True
        try:
            for slot, _j in new_kfs:
                pose_before = mc.map.kf_pose[slot].clone()
                if mc.try_close_loop(slot, self.generator, precomputed=loop_pre.get(slot)):
                    loop_rebase = (pose_before, mc.map.kf_pose[slot].clone())
                if self.on_keyframe is not None:
                    self.on_keyframe(self, slot)
                    if self.mapctx is not mc:
                        # merged into another map mid-walk: adopt_merged_map
                        # has rebased the tracker; the chunk's remaining
                        # keyframes now live in the merged map
                        return recs
        finally:
            self._in_chunk_finish = False
        if loop_rebase is not None and self._ts is not None:
            self._rebase_after_loop(*loop_rebase)
        # overlapped global BA: one slice per chunk boundary while scheduled
        mc.gba_slice()
        return recs

    # -- stereo / RGB-D (System::TrackStereo / TrackRGBD) --------------------
    def process_frame_stereo(self, image_left, image_right, timestamp: float) -> FrameRecord:
        imgL = torch.as_tensor(image_left, device=self.device)
        imgR = torch.as_tensor(image_right, device=self.device)
        with stage("orb.extract"):
            featsR = self.extract(imgR)
        return self._process_depth_frame(
            imgL, timestamp,
            lambda f: st.with_stereo(f, featsR, self.cfg.camera, self.cfg.orb.scale_factor,
                                     img_left=imgL, img_right=imgR))

    def process_frame_rgbd(self, image, depth_image, timestamp: float) -> FrameRecord:
        depth = torch.as_tensor(depth_image, device=self.device)
        return self._process_depth_frame(
            torch.as_tensor(image, device=self.device), timestamp,
            lambda f: st.with_depthmap(f, depth, self.cfg.camera))

    def _process_depth_frame(self, img, timestamp: float, attach_depth) -> FrameRecord:
        """The stereo/RGB-D state machine on the host tracking path."""
        self.frame_id += 1
        n_inl = 0

        def features():
            with stage("orb.extract"):
                feats = self.extract(img)
            return attach_depth(feats)

        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            feats = features()
            self.state = TrackingState.NOT_INITIALIZED
            if self.localization_only and self.mapctx.n_kf >= 1:
                n_inl = self._try_relocalize(feats)
            else:
                self._try_initialize_depth(feats, timestamp)
        elif self.state == TrackingState.OK:
            n_inl = self._track(features(), timestamp)
            if n_inl < self.cfg.tracking.min_inliers_local_map:
                self.state = TrackingState.LOST
                self._maybe_reset_young_map()
        elif (not self.cfg.multi_mapping or self.localization_only
              or self.on_keyframe is None or self.reloc_on_loss):
            # LOST with no MultiMapper owning the loss: relocalize
            n_inl = self._try_relocalize(features())
        return self._record(timestamp, n_inl)

    def _record(self, timestamp: float, n_inl: int) -> FrameRecord:
        ok_now = self.state == TrackingState.OK
        rec = FrameRecord(
            frame_id=self.frame_id,
            timestamp=timestamp,
            T_cw=_np(self.T_cw),
            state=self.state.name,
            n_inliers=n_inl,
            map_id=self.mapctx.map_id,
            ref_slot=self._last_ref[0] if ok_now else -1,
            T_rel=self._last_ref[1] if ok_now else None,
        )
        self.frames.append(rec)
        return rec

    # -- public API --------------------------------------------------------
    def process_frame(self, image, timestamp: float) -> FrameRecord:
        self._vocabulary_gate()
        self.frame_id += 1
        img = torch.as_tensor(image, device=self.device)
        n_inl = 0
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            if self.localization_only and self.mapctx.n_kf >= 2:
                # localization mode on a built map: no two-view init,
                # localize straight against the keyframe database
                self.state = TrackingState.NOT_INITIALIZED
                n_inl = self._try_relocalize(self.extract(img))
            else:
                feats = self.extract_init(img)
                self.state = TrackingState.NOT_INITIALIZED
                self._try_initialize(feats, timestamp)
        elif self.state == TrackingState.OK:
            n_inl = self._track_fused(img, timestamp)
            if n_inl < self.cfg.tracking.min_inliers_local_map:
                self.state = TrackingState.LOST
                self._maybe_reset_young_map()
        elif (not self.cfg.multi_mapping or self.localization_only
              or self.on_keyframe is None or self.reloc_on_loss):
            # LOST with no MultiMapper owning the loss (or multi-mapping
            # off): relocalize against the keyframe database
            # (Tracking::Relocalization, Tracking.cc:1404); a MultiMapper
            # with multi-mapping on starts a new map instead
            # (Tracking.cc:330-366)
            n_inl = self._try_relocalize(self.extract(img))
        return self._record(timestamp, n_inl)


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
        # a runtime toggle: try_close_loop checks it, and so does the
        # vocabulary gate
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
    def loops_closed(self):
        return self.tracker.mapctx.loops_closed

    @property
    def T_cw(self):
        return self.tracker.T_cw

    def activate_localization_mode(self):
        """Freeze the map; track and relocalize only (System.cc:375)."""
        self.tracker._sync_from_ts()
        self.tracker.mapctx.ensure_vocabulary()  # relocalization needs the database
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

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

    def summary(self) -> dict:
        s = self.tracker.mapctx.summary()
        s["state"] = self.tracker.state.name
        s["frames"] = len(self.frames)
        return s


@dataclass
class StereoSession(MonocularSession):
    """Rectified-stereo facade (System::TrackStereo): metric scale from the
    baseline, a one-keyframe bootstrap, close landmarks spawned from depth.
    ``process_frame(image_left, image_right, timestamp)``."""

    def __post_init__(self):
        if self.cfg.camera.bf <= 0:
            raise ValueError("StereoSession needs camera.bf > 0")
        self.cfg = self.cfg.replace(sensor="stereo")
        super().__post_init__()

    def process_frame(self, image_left, image_right, timestamp):
        return self.tracker.process_frame_stereo(image_left, image_right, timestamp)


@dataclass
class RGBDSession(MonocularSession):
    """RGB-D facade (System::TrackRGBD): a depth image registered to the
    image, the virtual right coordinate u - bf/d
    (Frame::ComputeStereoFromRGBD). ``process_frame(image, depth_image,
    timestamp)``, the depth in raw units (``camera.depth_map_factor`` per
    metre)."""

    def __post_init__(self):
        if self.cfg.camera.bf <= 0:
            raise ValueError("RGBDSession needs camera.bf > 0")
        self.cfg = self.cfg.replace(sensor="rgbd")
        super().__post_init__()

    def process_frame(self, image, depth_image, timestamp):
        return self.tracker.process_frame_rgbd(image, depth_image, timestamp)
