"""Multi-map / multi-robot coordination, the ORBSLAMM MultiMapper (port of
orbslamm_tpu/models/multimap.py).

  * every robot tracks into its own active map; on tracking loss with an
    established map the robot gets a brand-new map and keeps mapping
    (Tracking.cc:330-366); a young map is reset instead (Tracking.cc:520);
  * a registry holds all live maps; after every keyframe the newest keyframe
    (plus a rotating rescan window of older ones) is scored against every
    other map's BoW database; a hit is verified by a cross-map Sim3
    (>= 15 BoW matches, >= 20 inliers, >= 40 total, MultiMapper.cc:214,306);
  * on success the newer map's keyframes and landmarks are Sim3-transformed
    and appended into the base map's pools (MultiMapper.cc:451-665), the
    seam is refined by an essential-graph optimization, duplicate landmarks
    are fused around it, one global-BA slice runs, and the robots of the
    absorbed map switch to the base map with transformed state.

Scanning is deferred one round, as in the JAX package: keyframe events
enqueue query slots, each pump fetches the previous round's Sim3 verdicts
and scores, then dispatches new work. Eager CUDA is asynchronous too; the
host reads (``.cpu()``, ``bool``) are the sync points.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslamm_tpu_torch.models import local_mapping as lm_stage
from orbslamm_tpu_torch.models import loop_closing as lc_stage
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.models.system import MapContext, RobotTracker, TrackingState
from orbslamm_tpu_torch.ops import bow, geometry as geo
from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.utils.trace import get_tracer, stage


class MergeResult(NamedTuple):
    map: ms.MapState
    lm_remap: torch.Tensor  # [L_B] int32 — B landmark id -> merged slot (-1 unused)
    S_AB: torch.Tensor  # packed sim3: base world <- absorbed world
    n_evicted: torch.Tensor  # int32 — A landmarks evicted to make room for B's


def _stable_order(has: torch.Tensor) -> torch.Tensor:
    """Indices with the True rows first, each part in its original order
    (``argsort(~has, stable=True)``)."""
    return torch.sort((~has).to(torch.int32), stable=True).indices


def merge_maps(cfg: SlamConfig, mA: ms.MapState, mB: ms.MapState, S_cam_ab: torch.Tensor,
               slot_b, slot_a, n_kf_A) -> MergeResult:
    """Append map B into map A's pools, Sim3-transformed into A's world.
    ``S_cam_ab`` maps keyframe ``slot_b``'s camera coords (map B) to keyframe
    ``slot_a``'s (map A); B's keyframe k lands in A's slot ``n_kf_A + k``.
    Writes past a pool's end go nowhere (masked, not clamped)."""
    dev = mA.kf_pose.device
    S_aw = geo.sim3_from_se3(mA.kf_pose[slot_a])
    S_bw = geo.sim3_from_se3(mB.kf_pose[slot_b])
    # x_wA = S_aw^-1 o S_cam o S_bw (x_wB)
    S_AB = geo.sim3_compose(geo.sim3_inv(S_aw), geo.sim3_compose(S_cam_ab, S_bw))
    s_AB, R_AB, _ = geo.sim3_parts(S_AB)
    n_kf_A = torch.as_tensor(n_kf_A, dtype=torch.int32, device=dev)

    # --- landmarks: free slots first; on overflow A's worst landmarks (by
    # found ratio) are evicted, and their observations cleared from A's
    # keyframes so nothing aliases onto the transplanted points
    LB = mB.lm_pos.shape[0]
    LA = mA.lm_valid.shape[0]
    slots = ms.free_lm_slots(mA, LB, by_value=True)
    use = mB.lm_valid
    evict = use & mA.lm_valid[slots.long()]
    n_evicted = evict.sum().to(torch.int32)
    evict_mask = ms.mark(LA, slots, evict)
    dangling = (mA.kf_obs_lm >= 0) & evict_mask[torch.clamp_min(mA.kf_obs_lm, 0).long()]
    mA = mA._replace(kf_obs_lm=torch.where(dangling, -1, mA.kf_obs_lm),
                     lm_valid=mA.lm_valid & ~evict_mask)
    lm_remap = torch.where(use, slots, torch.full_like(slots, -1))
    mA = ms.add_landmarks(mA, slots, use, geo.sim3_apply(S_AB, mB.lm_pos), mB.lm_desc,
                          mB.lm_normal @ R_AB.T, mB.lm_dist_min * s_AB,
                          mB.lm_dist_max * s_AB, 0)
    # bookkeeping add_landmarks defaults: reference/first keyframe ids
    # (shifted into the merged keyframe space) and the view counters
    mA = mA._replace(
        lm_ref_kf=ms.set_rows(mA.lm_ref_kf, slots, n_kf_A + mB.lm_ref_kf, use),
        lm_first_kf=ms.set_rows(mA.lm_first_kf, slots, n_kf_A + mB.lm_first_kf, use),
        lm_visible=ms.set_rows(mA.lm_visible, slots, mB.lm_visible, use),
        lm_found=ms.set_rows(mA.lm_found, slots, mB.lm_found, use),
    )

    # --- keyframes: B slot k -> A slot n_kf_A + k
    KB = mB.kf_pose.shape[0]
    KA = mA.kf_pose.shape[0]
    dest = n_kf_A + torch.arange(KB, dtype=torch.int32, device=dev)
    put = mB.kf_valid & (dest < KA)
    T_new = geo.sim3_to_se3(geo.sim3_compose(geo.sim3_from_se3(mB.kf_pose),
                                             geo.sim3_inv(S_AB)))
    obs_new = torch.where(mB.kf_obs_lm >= 0,
                          lm_remap[torch.clamp_min(mB.kf_obs_lm, 0).long()],
                          torch.full_like(mB.kf_obs_lm, -1))

    def moved(dst, src):
        return ms.set_rows(dst, dest, src, put)

    mA = mA._replace(
        kf_pose=moved(mA.kf_pose, T_new),
        kf_K=moved(mA.kf_K, mB.kf_K),
        kf_valid=moved(mA.kf_valid, mB.kf_valid),
        # SetNotFixed: absorbed origin keyframes lose their gauge-anchor
        # status (MultiMapper.cc:527, Optimizer.cc:99)
        kf_fixed=moved(mA.kf_fixed, False),
        kf_frame_id=moved(mA.kf_frame_id, mB.kf_frame_id),
        kf_timestamp=moved(mA.kf_timestamp, mB.kf_timestamp),
        kf_xy=moved(mA.kf_xy, mB.kf_xy),
        kf_desc=moved(mA.kf_desc, mB.kf_desc),
        kf_level=moved(mA.kf_level, mB.kf_level),
        kf_angle=moved(mA.kf_angle, mB.kf_angle),
        kf_feat_valid=moved(mA.kf_feat_valid, mB.kf_feat_valid),
        kf_obs_lm=moved(mA.kf_obs_lm, obs_new),
        kf_ur=moved(mA.kf_ur, mB.kf_ur),
        n_kf=torch.maximum(mA.n_kf, n_kf_A + mB.n_kf),
    )
    # B's recorded loop edges, shifted into A's slot space, go into A's free
    # rows: past seams keep constraining later essential graphs
    # (KeyFrame::AddLoopEdge survives the merge, MultiMapper.cc:648-655)
    E = mA.loop_edges.shape[0]
    a_has = mA.loop_edges[:, 0] >= 0
    a_sorted = mA.loop_edges[_stable_order(a_has)]  # used rows first
    b_has = mB.loop_edges[:, 0] >= 0
    b_sorted = mB.loop_edges[_stable_order(b_has)]
    b_live = b_sorted[:, 0] >= 0
    b_sorted = torch.where(b_live[:, None], b_sorted + n_kf_A, -1)
    rows = a_has.sum() + torch.arange(E, device=dev)
    mA = mA._replace(loop_edges=ms.set_rows(a_sorted, rows, b_sorted, b_live & (rows < E)))
    return MergeResult(map=mA, lm_remap=lm_remap, S_AB=S_AB, n_evicted=n_evicted)


class MultiMapper:
    """Global registry and merge scanner shared by all robots (one instance
    per deployment, reference MultiMapper.cc:32). ``device`` is where every
    map and tracker lives; the caller always names it."""

    def __init__(self, cfg: SlamConfig, *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.maps: list[MapContext] = []
        self.robots: list[RobotTracker] = []
        self.voc: bow.Vocabulary | None = None
        if cfg.vocabulary_path:
            # a file vocabulary is shared by every map from the start
            self.voc = MapContext.load_vocabulary_file(cfg, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(1)
        self.merges: list[tuple] = []
        self.merge_evictions: list[int] = []  # landmarks evicted per merge
        # runtime multi-mapping toggle (Viewer "Multi-Mapping" menu ->
        # Tracking::InformMultiMapping, Viewer.cc:131-152): off makes a lost
        # robot relocalize instead of starting a new map
        self.multi_mapping_enabled = cfg.multi_mapping
        # per-map newest->oldest rescan cursor (the MultiMapper.cc:124 walk,
        # spread over keyframe events)
        self._rescan_cursor: dict[int, int] = {}
        # deferred scanning: keyframe events enqueue query slots; each pump
        # dispatches one batched scoring per (map, base map) pair and reads
        # the previous round's results
        self._scan_queue: dict[int, list[int]] = {}  # map_id -> slots
        self._scan_pending: list[dict] = []
        self._verify_pending: list[dict] = []  # dispatched Sim3 verifications
        self.scan_batch = 4  # query slots per scoring call
        # a failed Sim3 verification backs off for a few pump rounds
        self._verify_cooldown: dict[tuple, int] = {}
        self._pump_round = 0

    # -- registry ----------------------------------------------------------
    def new_map(self) -> MapContext:
        mc = MapContext(self.cfg, voc=self.voc, device=self.device)
        self.maps.append(mc)
        return mc

    def add_robot(self, name: str = "") -> RobotTracker:
        name = name or f"robot{len(self.robots)}"
        t = RobotTracker(self.cfg, self.new_map(), name, device=self.device)
        t.on_keyframe = self._on_keyframe
        t.auto_reset_young = False  # loss handling belongs to _handle_loss
        self.robots.append(t)
        return t

    def live_maps(self) -> list[MapContext]:
        return [m for m in self.maps if m.merged_into is None]

    # -- per-frame driver --------------------------------------------------
    def process_frame(self, robot_idx: int, image, timestamp):
        t = self.robots[robot_idx]
        with get_tracer().span("track", robot=t.name):
            rec = t.process_frame(image, timestamp)
        if t.state == TrackingState.LOST and self.multi_mapping_enabled:
            self._handle_loss(t, float(timestamp))
        return rec

    def set_multi_mapping(self, on: bool):
        """Runtime toggle: off makes a lost robot relocalize against its
        current map instead of starting a new one."""
        self.multi_mapping_enabled = bool(on)
        for t in self.robots:
            t.reloc_on_loss = not on
        get_tracer().event("multi_mapping_toggled", on=bool(on))

    def process_frames(self, robot_idx: int, images, timestamps):
        """Pipelined chunk driver for one robot: chunk k+1 is dispatched
        before chunk k's summaries are read (keyframe events and loss
        handling one chunk late, the reference's asynchronous delay); the
        merge pump runs at every chunk boundary. Init and loss frames take
        the per-frame path with new-map-on-loss, and so does every frame of
        a robot with ``use_fused`` off."""
        t = self.robots[robot_idx]
        tr = get_tracer()
        recs = []
        pending = None

        def finish(tok):
            out = t._finish_chunk(tok)
            self.pump_merge_scans()  # once per chunk boundary
            if t.state == TrackingState.LOST and self.cfg.multi_mapping:
                self._handle_loss(t, out[-1].timestamp if out else 0.0)
            return out

        i, n = 0, len(timestamps)
        while i < n:
            cs = t.chunk_size
            if t.state == TrackingState.OK and t.use_fused and n - i >= cs:
                with tr.span("track", robot=t.name, chunk=cs):
                    tok = t._dispatch_chunk(images[i:i + cs], timestamps[i:i + cs])
                i += cs
                if pending is not None:
                    recs.extend(finish(pending))
                pending = tok
            else:
                if pending is not None:
                    recs.extend(finish(pending))
                    pending = None
                    continue  # state may have changed — re-evaluate
                recs.append(self.process_frame(robot_idx, images[i], float(timestamps[i])))
                i += 1
        if pending is not None:
            recs.extend(finish(pending))
        return recs

    def _handle_loss(self, t: RobotTracker, timestamp: float):
        if not self.multi_mapping_enabled:
            return  # the relocalization path owns the loss (reloc_on_loss)
        if t.mapctx.n_kf >= self.cfg.tracking.min_kfs_for_new_map:
            # keep the orphan map; continue in a brand-new one (the ORBSLAMM
            # signature, Tracking.cc:330-366)
            t.switch_map(self.new_map())
            tr = get_tracer()
            tr.incr("new_maps_on_loss")
            tr.event("new_map_on_loss", robot=t.name, map_id=t.mapctx.map_id, ts=timestamp)
        else:
            # early loss: reset the young map (Tracking.cc:520-528); the
            # fresh map_id orphans the discarded generation's records
            mc = t.mapctx
            mc.map = ms.empty_map(self.cfg, device=self.device)
            mc.n_kf = 0
            if mc.kf_bow is not None:
                mc.kf_bow = torch.zeros_like(mc.kf_bow)
            mc.renew_id()
            t.switch_map(mc)

    # -- keyframe hook: vocabulary + merge scan ----------------------------
    def _on_keyframe(self, tracker: RobotTracker, slot: int):
        if self.voc is None:
            if not tracker.mapctx.ensure_vocabulary():
                return
            # the first trained vocabulary is every map's
            self.voc = tracker.mapctx.voc
            for mc in self.maps:
                if mc.voc is None:
                    mc.voc = self.voc
                    mc._alloc_bow()
                    kv = mc.map.kf_valid.cpu().numpy()
                    mc.update_bow_rows([int(s) for s in np.nonzero(kv)[0]])
        self.enqueue_scan(tracker.mapctx, slot)
        # the pump runs at chunk boundaries (process_frames); the per-frame
        # path pumps here
        if not tracker._in_chunk_finish:
            self.pump_merge_scans()

    # -- merging -----------------------------------------------------------
    def enqueue_scan(self, mcB: MapContext, slot: int):
        """Queue a keyframe for cross-map scanning: the new keyframe plus a
        rotating newest->oldest rescan window (the reference walks every
        keyframe of the newer map, newest first, MultiMapper.cc:124; the
        cursor spreads that coverage over keyframe events)."""
        cfg = self.cfg
        if mcB.n_kf < cfg.loop.min_kfs_for_merge or mcB.kf_bow is None:
            return
        slots = [slot]
        cursor = self._rescan_cursor.get(mcB.map_id, mcB.n_kf - 1)
        for _ in range(cfg.loop.merge_rescan_per_kf):
            cursor -= 1
            if cursor < 0:
                cursor = mcB.n_kf - 1
            if cursor not in slots:
                slots.append(cursor)
        self._rescan_cursor[mcB.map_id] = cursor
        q = self._scan_queue.setdefault(mcB.map_id, [])
        q.extend(s for s in slots if s not in q)
        del q[: max(0, len(q) - 2 * self.scan_batch)]  # cap; the cursor re-covers

    def pump_merge_scans(self) -> bool:
        """One round of the deferred pipeline: resolve the previous round's
        Sim3 verifications and scores, then dispatch scoring for the queued
        slots. Returns True if a merge happened."""
        self._pump_round += 1
        if self._fetch_and_verify_scans():
            self._scan_pending = []
            self._verify_pending = []
            self._scan_queue.clear()
            return True
        self._dispatch_scans()
        return False

    def flush_merge_scans(self, rounds: int = 3) -> bool:
        """Drain the scan pipeline synchronously (end of a run, and callers
        that need the result now)."""
        for _ in range(rounds):
            if self.pump_merge_scans():
                return True
        return self._fetch_and_verify_scans()

    def _dispatch_scans(self):
        cfg = self.cfg
        for map_id, slots in list(self._scan_queue.items()):
            mcB = next((m for m in self.maps if m.map_id == map_id), None)
            if mcB is None or mcB.merged_into is not None or not slots:
                self._scan_queue.pop(map_id, None)
                continue
            take = slots[-self.scan_batch:]
            self._scan_queue[map_id] = slots[: -len(take)]
            padded = (take + [take[0]] * self.scan_batch)[: self.scan_batch]
            for mcA in self.live_maps():
                if mcA is mcB or mcA.kf_bow is None:
                    continue
                if mcA.n_kf < cfg.loop.min_kfs_for_merge:
                    continue
                if mcA.n_kf + mcB.n_kf >= cfg.capacity.max_keyframes:
                    # the merged map would not fit
                    get_tracer().event("merge_skipped_capacity", base=mcA.map_id,
                                       absorbed=mcB.map_id, n_kf_base=mcA.n_kf,
                                       n_kf_absorbed=mcB.n_kf,
                                       capacity=cfg.capacity.max_keyframes)
                    continue
                with stage("merge.scan"):
                    out = lc_stage.batched_merge_scan_scores(cfg, mcB.map, mcB.kf_bow, padded,
                                                             mcA.map, mcA.kf_bow)
                self._scan_pending.append({"mcB": mcB, "mcA": mcA, "slots": take, "out": out})

    def _fetch_and_verify_scans(self) -> bool:
        """Read the previous round's Sim3 verdicts (merge on the first
        success), then turn this round's scores into new verifications. Both
        stages read one pump late, so neither waits on fresh device work."""
        verifies, self._verify_pending = self._verify_pending, []
        for v in verifies:
            mcB, mcA = v["mcB"], v["mcA"]
            if mcB.merged_into is not None or mcA.merged_into is not None:
                continue
            ls = v["ls"]
            if bool(ls.success):
                # map-swap rule (MultiMapper.cc:372-393): the older map (lower
                # id, the deployment's original gauge) stays the base
                if mcB.map_id < mcA.map_id:
                    self._do_merge(mcB, mcA, geo.sim3_inv(ls.S_ba), v["cand"], v["slot"])
                else:
                    self._do_merge(mcA, mcB, ls.S_ba, v["slot"], v["cand"])
                self._verify_pending = []
                return True
            self._verify_cooldown[(mcB.map_id, mcA.map_id, v["cand"])] = self._pump_round
        pending, self._scan_pending = self._scan_pending, []
        for tok in pending:
            if tok["mcB"].merged_into is not None or tok["mcA"].merged_into is not None:
                continue
            with get_tracer().span("merge_scan", absorbed=tok["mcB"].map_id,
                                   base=tok["mcA"].map_id), stage("merge.verify"):
                self._dispatch_verifies(tok)
        return False

    def _dispatch_verifies(self, tok):
        """Floor and group selection on one fetched score batch, then the
        Sim3 verification of each selected candidate (read at the next
        pump)."""
        cfg = self.cfg
        mcB, mcA = tok["mcB"], tok["mcA"]
        scores_q, min_q, acc_q, nb_q = (x.cpu().numpy() for x in tok["out"])
        for qi, slot in enumerate(tok["slots"]):
            scores = scores_q[qi]
            floor = max(float(min_q[qi]), 0.015)
            if float(scores.max()) < floor:
                continue
            masked = np.where(scores >= floor, acc_q[qi], -1.0)
            nb = nb_q[qi]
            for _ in range(cfg.loop.top_k_candidates):
                rep = int(masked.argmax())
                if masked[rep] <= 0:
                    break
                # the best-scoring member of the winning group
                # (pBestCandidateKF, KeyFrameDatabase.cc:170-190)
                cand = int(np.argmax(np.where(nb[rep], scores, -1.0)))
                masked[nb[rep]] = -1.0
                key = (mcB.map_id, mcA.map_id, cand)
                if self._pump_round - self._verify_cooldown.get(key, -99) < 2:
                    continue
                ls = lc_stage.compute_loop_sim3_cross(cfg, mcB.map, mcA.map, slot, cand,
                                                      self.generator)
                self._verify_pending.append({"mcB": mcB, "mcA": mcA, "slot": slot,
                                             "cand": cand, "ls": ls})

    def try_merge(self, tracker: RobotTracker, slot: int) -> bool:
        """Scan and verify one keyframe now (the keyframe events use
        enqueue_scan + pump_merge_scans)."""
        self.enqueue_scan(tracker.mapctx, slot)
        return self.flush_merge_scans()

    def _do_merge(self, mcA: MapContext, mcB: MapContext, S_cam, slot_b: int, slot_a: int):
        tr = get_tracer()
        tr.event("map_merge", absorbed=mcB.map_id, base=mcA.map_id, slot_b=slot_b,
                 slot_a=slot_a)
        tr.incr("map_merges")
        with tr.span("merge", absorbed=mcB.map_id, base=mcA.map_id), stage("merge.apply"):
            self._do_merge_inner(mcA, mcB, S_cam, slot_b, slot_a)

    def _do_merge_inner(self, mcA: MapContext, mcB: MapContext, S_cam, slot_b: int,
                        slot_a: int):
        cfg = self.cfg
        nA, nB = mcA.n_kf, mcB.n_kf
        res = merge_maps(cfg, mcA.map, mcB.map, S_cam, slot_b, slot_a, nA)
        mcA.map = res.map
        n_evicted = int(res.n_evicted)
        self.merge_evictions.append(n_evicted)
        if n_evicted:
            get_tracer().event("merge_landmarks_evicted", base=mcA.map_id,
                               absorbed=mcB.map_id, n_evicted=n_evicted)
        merged_slot_b = nA + slot_b
        mcA.n_kf = nA + nB
        # anchors for the rebases after the correction: A-side robots ride
        # A's newest keyframe, B-side robots their own transplanted newest
        # keyframe (the seam correction moves the B cluster by the whole
        # inter-map drift; System.cc:470-499 per side). 4x4 inverses in
        # float64 numpy: tracked poses drift off SO(3)
        anchor, anchor_b = nA - 1, nA + nB - 1
        T_anchor_before = _f64(mcA.map.kf_pose[anchor])
        T_anchor_b_before = _f64(mcA.map.kf_pose[anchor_b])
        # the absorbed keyframes' BoW rows (appearance is unchanged); the
        # start clamps so the block fits, as lax.dynamic_update_slice's
        kf_bow = mcA.kf_bow.clone()
        start = max(0, min(nA, kf_bow.shape[0] - nB))
        kf_bow[start:start + nB] = mcB.kf_bow[:nB]
        mcA.kf_bow = kf_bow
        # seam refinement: essential graph with the merge pair as the loop
        # edge (MMOptimizeEssentialGraph, MultiMapper.cc:646)
        mcA.map = lc_stage.correct_loop(cfg, mcA.map, merged_slot_b, slot_a, S_cam)
        # fuse duplicate landmarks around the seam (SearchAndFuse, :668)
        for s in (merged_slot_b, slot_a):
            mcA.map = lm_stage.fuse_neighbors(cfg, mcA.map, s)
        # one immediate global-BA slice; the rest run at chunk boundaries
        with stage("gba.slice"):
            mcA.map, gba_cost = lc_stage.global_bundle_adjust(
                cfg, mcA.map, iters=mcA.gba_slice_iters, cg_iters=mcA.gba_cg_iters)
            mcA.gba_slices_run += 1
        mcA.schedule_gba(first_cost=float(gba_cost))
        T_anchor_after = _f64(mcA.map.kf_pose[anchor])
        mcA.last_merge_rebase = (T_anchor_before, T_anchor_after)
        # A-side robots ride the correction; their device tracking state is
        # rebuilt at their next chunk with a fresh indicator
        A_delta = np.linalg.inv(T_anchor_before) @ T_anchor_after
        for r in self.robots:
            if r.mapctx is mcA:
                r._sync_from_ts()
                r.T_cw = self._tensor(_f64(r.T_cw) @ A_delta)
                r.last_T = r.T_cw
                r.prev_inliers = 0  # collapse gate disarmed for one frame
        # B-side robots switch to the merged map; after the S_AB adoption
        # their poses are in pre-correction merged coordinates, so the B
        # anchor's movement is threaded through
        B_delta = np.linalg.inv(T_anchor_b_before) @ _f64(mcA.map.kf_pose[anchor_b])
        for r in self.robots:
            if r.mapctx is mcB:
                r.adopt_merged_map(mcA, res.S_AB, res.lm_remap)
                r.T_cw = self._tensor(_f64(r.T_cw) @ B_delta)
                r.last_T = r.T_cw
        # B's recorded frames into A's world: the frozen poses ride the
        # Sim3, the reference-keyframe decomposition is re-pointed at the
        # transplanted slots with its translation scaled by the merge scale,
        # so B-era frames resolve against A's current keyframe poses
        # (System.cc:470-499)
        S_inv = geo.sim3_inv(res.S_AB)
        s_AB = float(geo.sim3_parts(res.S_AB)[0])
        retro = [f for r in self.robots for f in r.frames
                 if f.map_id == mcB.map_id and f.state == "OK"]
        if retro:
            T_all = self._tensor(np.stack([f.T_cw for f in retro]))
            T_new_all = geo.sim3_to_se3(geo.sim3_compose(geo.sim3_from_se3(T_all), S_inv))
            for f, T_n in zip(retro, T_new_all.cpu().numpy()):
                f.T_cw = T_n
                f.map_id = mcA.map_id
                if f.ref_slot >= 0:
                    f.ref_slot += nA
                if f.T_rel is not None:
                    T = np.array(f.T_rel)
                    T[:3, 3] *= s_AB
                    f.T_rel = T
        mcB.merged_into = mcA
        self.merges.append((mcB.map_id, mcA.map_id, slot_b, slot_a))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def summary(self) -> dict:
        return {
            "n_maps": len(self.live_maps()),
            "n_robots": len(self.robots),
            "merges": list(self.merges),
            "maps": [m.summary() for m in self.live_maps()],
        }


def _f64(T) -> np.ndarray:
    return (T.detach().cpu().numpy() if torch.is_tensor(T) else np.asarray(T)).astype(np.float64)
