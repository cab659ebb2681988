"""Robot-parallel stream bank (port of orbslamm_tpu/parallel/streams.py):
R SLAM streams advanced together, one chunk per call.

The reference runs one ``System`` (a set of threads) per robot inside one
process, sharing one MultiMapper (mono_kitti_dif-Seq.cc:87-101). The JAX
package stacks every robot's state along a leading ``[R, ...]`` axis and
vmaps one chunk program over it. Eager PyTorch gains nothing from a stack
until every op takes a robot dimension, so here the bank keeps a list of
per-robot ``MapState`` / ``TrackState`` / BoW databases, and its chunk step
runs each robot's deferred-mapping chunk (``fused.chunk_deferred``) in index
order. What the bank adds is the JAX package's:

  * the robot axis over a device mesh (``mesh=``, ``multihost.stream_mesh``):
    robot ``r`` of ``R`` lives on slot ``r * len(mesh) // R``, its map,
    tracking state, BoW database and ``K`` on that slot's device, and its
    chunk is dispatched there. The launches are asynchronous, so chunks on
    separate cards overlap up to each segment's one host read. Robots need
    no collectives; a merge, refresh or replay copies slices between the
    slot devices and the trackers' device with ``.to``;
  * one fetch per chunk: every robot's summaries and keyframe events, and
    the pending global-BA costs, in one device-to-host copy per device;
  * the pipeline: chunk k+1 is dispatched before chunk k's events run;
    a same-map loop correction rebases the in-flight chunk's records and the
    robot's tracking state, a global-BA slice rewrites the robot's current
    slice;
  * generations: a merge, reset or shared refresh bumps the robot's
    generation, and a chunk dispatched under an older one is stale: its
    records go out under the map it was dispatched in, and it runs no state
    machine and no keyframe events;
  * owner and followers: when two bank robots end on one merged map, the
    robot whose map absorbed the other keeps the authoritative map; a
    follower tracks and maps in its own copy, and its new keyframes are
    replayed into the authoritative map at sync points, every
    ``REPLAY_INTERVAL`` chunks (``_replay_kfs_device``).

All streams share the image size and ORB configuration (one extractor per
device); each robot keeps its own calibration ``K``.

Every map, TrackState and BoW database written into a bank slice from a
tracker or map context, or read back from one, is copied tensor by tensor:
a follower's copy and the authoritative map never share storage.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from orbslamm_tpu_torch.models import fused
from orbslamm_tpu_torch.models import local_mapping as lm_stage
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.models.system import FrameRecord, TrackingState
from orbslamm_tpu_torch.ops import bow as bow_ops
from orbslamm_tpu_torch.ops import orb as orb_ops
from orbslamm_tpu_torch.ops.orb import Features
from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.utils.trace import stage

# chunks between sync points while a follower has a backlog
REPLAY_INTERVAL = 4


def make_multistream_chunk_step(cfg: SlamConfig, extract_on, *, with_bow: bool = False):
    """The bank's chunk step: the deferred-mapping chunk for each robot, in
    index order.

    ``extract_on(device)`` is the extractor on ``device``: robot ``r``'s
    images are extracted on its device, the device of its ``K`` (the bank
    passes a subset of its robots when some are on the per-frame path, so
    nothing is indexed by robot). Returns step(m[R], ts[R], kf_bow[R], K[R],
    images[R][C], frame_ids[R][C], timestamps[R][C], allow_kf[R], vocs[R])
    -> lists (m[R], ts[R], kf_bow[R], summaries[R], kf_events[R]); each
    robot's summaries are stacked along dim 0, and its events hold
    ``fused.KMAX`` entries per segment. With ``with_bow`` each inserted
    keyframe's BoW row and loop scan run inside the chunk against
    ``vocs[r]``, robot ``r``'s copy of the one shared vocabulary; without it
    ``kf_bow`` passes through untouched and ``vocs`` is not read."""

    def step(m_all, ts_all, bow_all, K_all, images, frame_ids, timestamps, allow_kf,
             vocs=None):
        out = ([], [], [], [], [])
        for r in range(len(m_all)):
            with _on(K_all[r].device):
                with stage("orb.extract"):
                    ext = extract_on(K_all[r].device)
                    feats = [ext(img) for img in images[r]]
                res = fused.chunk_deferred(
                    cfg, m_all[r], ts_all[r], bow_all[r], vocs[r] if with_bow else None, feats,
                    frame_ids[r], timestamps[r], K_all[r], allow_kf[r])
            for acc, x in zip(out, res):
                acc.append(x)
        return out

    return step


def shard_streams(n_robots: int, mesh, device) -> list[torch.device]:
    """The device of each of ``n_robots`` robots: robot ``r`` on slot
    ``r * len(mesh) // n_robots`` of ``mesh`` (contiguous blocks of robots
    per slot, as the JAX package shards the robot axis), or every robot on
    ``device`` without a mesh."""
    if mesh is None:
        return [_indexed(device)] * n_robots
    devs = mesh.flat
    return [devs[r * len(devs) // n_robots] for r in range(n_robots)]


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card's), so that
    one device has one key."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on(device):
    """The current CUDA device set to ``device`` for the launches inside
    (nothing to set on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _copy(tree, device=None):
    """A copy of a tensor, or of a (nested) NamedTuple of tensors, that
    shares no storage with it, on ``device`` (default: where it lies)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.clone() if device is None else tree.to(device, copy=True)
    return type(tree)(*(_copy(x, device) for x in tree))


def _move(tree, device):
    """``tree`` on ``device``; tensors already there are not copied."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.to(device)
    return type(tree)(*(_move(x, device) for x in tree))


_NUMPY_DTYPE = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def _fetch(tree):
    """Every tensor of ``tree`` (nested lists, tuples and NamedTuples) to
    the host in one copy per device. Each device's tensors travel as one
    float64 buffer, which holds their int32, bool and float32 values
    exactly, and come back as numpy arrays of their own dtypes in the same
    structure."""
    leaves = []

    def walk(x):
        if torch.is_tensor(x):
            leaves.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)

    walk(tree)
    if not leaves:
        return tree
    by_dev: dict = {}  # device -> indices of its leaves
    for i, x in enumerate(leaves):
        by_dev.setdefault(x.device, []).append(i)
    host = [None] * len(leaves)
    for idx in by_dev.values():
        flat = torch.cat([leaves[i].reshape(-1).to(torch.float64) for i in idx]).cpu().numpy()
        offsets = np.cumsum([0] + [leaves[i].numel() for i in idx])
        for k, i in enumerate(idx):
            host[i] = flat[offsets[k]:offsets[k + 1]]
    it = iter(range(len(leaves)))

    def build(x):
        if torch.is_tensor(x):
            return host[next(it)].reshape(tuple(x.shape)).astype(_NUMPY_DTYPE[x.dtype])
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(build(y) for y in x))
        if isinstance(x, (list, tuple)):
            return type(x)(build(y) for y in x)
        return x

    return build(tree)


def _replay_kfs_device(cfg: SlamConfig, mA: ms.MapState, bowA, voc, mB: ms.MapState,
                       src_slots, base_valid, n_kf0: int, n_allowed: int, with_bow: bool):
    """Replay follower keyframes into the authoritative map ``mA``.

    ``src_slots`` (padded with -1): keyframe slots of the follower's copy
    ``mB``. Entry e (while e < ``n_allowed`` and a slot stays below the
    pool's last) goes to slot ``n_kf0``, ``n_kf0 + 1``, ... of ``mA``
    through a light pipeline, insert and seam fuse: the full mapping
    pipeline already ran in the copy. Only the associations to landmarks
    that are valid in ``mA`` and were valid at the last shared refresh
    (``base_valid``) are kept: ids allocated since in the copy name other
    landmarks in ``mA``. With ``with_bow`` the BoW rows of the inserted
    slots are computed in one batch at the end. The JAX package scans the
    entries on the device under ``lax.cond``; here the host walks them.
    Returns (mA, bowA)."""
    src_slots = [int(s) for s in src_slots]
    n_kf = int(n_kf0)
    for e, src in enumerate(src_slots):
        if src < 0 or e >= n_allowed or n_kf >= cfg.capacity.max_keyframes - 1:
            continue
        valid = mB.kf_feat_valid[src]
        feats = Features(
            xy=mB.kf_xy[src], xy_raw=mB.kf_xy[src], angle=mB.kf_angle[src],
            response=torch.where(valid, 50.0, 0.0), level=mB.kf_level[src],
            desc=mB.kf_desc[src], valid=valid, u_right=mB.kf_ur[src])
        obs = mB.kf_obs_lm[src]
        safe = torch.clamp_min(obs, 0)
        keep = (obs >= 0) & mA.lm_valid[safe] & base_valid[safe]
        obs = torch.where(keep, obs, torch.full_like(obs, -1))
        mA = ms.insert_keyframe(mA, n_kf, mB.kf_pose[src], mB.kf_K[src], feats, obs,
                                mB.kf_frame_id[src], mB.kf_timestamp[src])
        mA = lm_stage.fuse_neighbors(cfg, mA, n_kf)
        n_kf += 1
    if with_bow and n_kf > n_kf0:
        bowA = bow_ops.update_bow_rows(voc, mA.kf_desc, mA.kf_feat_valid, bowA,
                                       list(range(int(n_kf0), n_kf)))
    return mA, bowA


class StreamBank:
    """Drives R bootstrapped RobotTrackers through the bank's chunk step.

    Bootstrap each robot on the per-frame path until it is OK (two-view
    initialization is a rare host-decided event), then
    ``bank = StreamBank(cfg, trackers, device=..., mesh=...)`` and call
    ``bank.process_chunk(images[R, C], stamps[R, C])`` for each chunk of
    ``chunk_size`` frames. The trackers live on ``device``; with a ``mesh``
    (``multihost.stream_mesh``) robot ``r`` of ``R`` runs on slot
    ``r * len(mesh) // R`` (``shard_streams``), without one on ``device``;
    ``bank.sync_to_trackers()`` writes the device state back into the
    trackers for trajectory export and merging.

    Loss: a robot that loses tracking keeps a frozen slice (the chunk body
    latches ``lost``) while the per-frame path takes over its images; the
    ``on_lost`` hook (wire it to MultiMapper._handle_loss for a new map on
    loss, Tracking.cc:330-366) decides the recovery, and once the robot is
    OK again its state is re-adopted into the bank (``reset_stream``). A
    robot on the per-frame path runs no device work in the chunk: the JAX
    package's vmap runs its frozen slice as no-ops whose output nothing reads
    before ``reset_stream`` overwrites it.

    Cross-robot merges (MultiMapper.cc:451-665): when two bank robots end
    on one merged MapContext, the robot whose map absorbed the other keeps
    the authoritative map in its slice (the owner); the follower tracks and
    inserts keyframes in a copy. Its keyframes gather in a backlog that a
    sync point, every ``REPLAY_INTERVAL`` chunks, replays into the
    authoritative map (the pipeline drains once), after which every member's
    slice is refreshed from it. The delay is the pipelined analog of the
    reference's keyframe queue (LocalMapping.cc:114-126).

    ``events`` lists what the bank did as (name, fields): ``bank_follower``,
    ``bank_replay_kf``, ``bank_backlog_dropped``, ``bank_owner_promoted``
    and ``bank_replay_skipped_capacity``."""

    def __init__(self, cfg: SlamConfig, trackers, *, device, mesh=None, chunk_size: int = 8):
        self.cfg = cfg
        self.device = torch.device(device)
        self.trackers = list(trackers)
        self.chunk_size = chunk_size
        if not self.trackers:
            raise ValueError("StreamBank needs at least one tracker")
        for t in self.trackers:
            if t.device != self.device:
                raise ValueError(f"tracker {t.name} lives on {t.device}, the bank on {self.device}")
        self.mesh = mesh
        self._devs = shard_streams(len(self.trackers), mesh, self.device)
        # one extractor per device, and per device the shared vocabulary's
        # copy there: device -> (vocabulary, its copy)
        self._extractors = {_indexed(self.device): self.trackers[0].extract}
        self._vocs: dict = {}
        # the step is built on first use and rebuilt once when the shared
        # vocabulary appears (the with_bow step maps BoW rows and loop scans
        # inside the chunk)
        self._step = None
        self._step_bow = False
        self.bow_all = None  # per-robot [K, n_words] databases when with_bow
        self._pending = None  # the dispatched chunk whose events have not run
        for t in self.trackers:
            if t._ts is None:
                t._ts = t._make_ts()
        self.m_all = [_copy(t.mapctx.map, d) for t, d in zip(self.trackers, self._devs)]
        self.ts_all = [_copy(t._ts, d) for t, d in zip(self.trackers, self._devs)]
        self.K_all = [t.K.to(d) for t, d in zip(self.trackers, self._devs)]
        # a tracker's map context goes stale while the bank runs its robot;
        # dirty robots are synced before keyframe events read other maps
        self._dirty = [False] * len(self.trackers)
        # per-robot generation, bumped by every host-side slice overwrite
        # (merge adoption, shared refresh, stream reset); a chunk dispatched
        # under an older generation is stale for that robot
        self._gens = [0] * len(self.trackers)
        # per-robot pose rebase A (np [4,4]) for the in-flight chunk's
        # records after a loop correction moved the map (T_cw' = T_cw A)
        self._rebase: dict[int, np.ndarray] = {}
        # follower -> owner, for robots sharing a merged MapContext
        self.followers: dict[int, int] = {}
        # follower -> [(record, copy slot, T_rel)] whose reference keyframe
        # is a copy-local slot not replayed yet
        self._pending_ref: dict[int, list] = {}
        # follower -> copy-local keyframe slots waiting for the sync point
        self._follower_backlog: dict[int, list[int]] = {}
        # owner -> loop corrections (T_old, T_new) to thread through the
        # followers' TrackStates at the next sync point (the owner itself is
        # rebased at once)
        self._shared_rebase: dict[int, list] = {}
        self._chunks_since_sync = 0
        self._want_sync = False
        self.sync_points = 0  # sync points run so far
        # owner -> lm_valid of the authoritative map at the last refresh
        self._shared_lm_valid: dict[int, torch.Tensor] = {}
        # follower -> authoritative n_kf at its last refresh: copy slots
        # below it are the merge transplant or replayed keyframes
        self._follower_base_nkf: dict[int, int] = {}
        # called once when a robot turns LOST (MultiMapper._handle_loss)
        self.on_lost = None
        # called once at the end of every chunk's events
        # (MultiMapper.pump_merge_scans)
        self.on_chunk_end = None
        self.events: list[tuple[str, dict]] = []

    @property
    def n_streams(self) -> int:
        return len(self.trackers)

    def count(self, name: str) -> int:
        """How many events of ``name`` the bank has recorded."""
        return sum(1 for n, _ in self.events if n == name)

    def _event(self, name: str, **fields):
        self.events.append((name, fields))

    def _tensor(self, a, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device or self.device)

    def _i32(self, v: int, device=None) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=device or self.device)

    def _extract_on(self, device):
        if device not in self._extractors:
            self._extractors[device] = orb_ops.make_extractor(self.cfg.orb, self.cfg.camera,
                                                              device=device)
        return self._extractors[device]

    def _voc_on(self, voc, device):
        held = self._vocs.get(device)
        if held is None or held[0] is not voc:
            held = (voc, voc if voc.nodes.device == device else voc.to(device))
            self._vocs[device] = held
        return held[1]

    def process_chunk(self, images, timestamps):
        """Advance every stream by one chunk, always pipelined.

        images: [R, C, H, W] uint8, timestamps: [R, C] with C the bank's
        ``chunk_size``. Robots that are not
        OK take the per-frame path (initialization, loss recovery) and
        rejoin the bank when OK. Chunk k+1 is dispatched before chunk k's
        events run; returns chunk k's per-robot FrameRecord lists ([] on the
        first call, plus any records a sync point drained). ``flush()`` or
        ``sync_to_trackers()`` finishes the in-flight chunk."""
        C = len(timestamps[0])
        if C != self.chunk_size:
            raise ValueError(f"a chunk of {C} frames to a bank of chunk_size {self.chunk_size}")
        out = []
        if self._want_sync:
            # sync point: drain the pipeline once and reconcile the shared map
            out += self.flush()
            self._do_shared_sync()
        host_handled = set()
        for r, t in enumerate(self.trackers):
            if t.state != TrackingState.OK:
                host_handled.add(r)
                for j in range(C):
                    t.process_frame(np.asarray(images[r][j]), float(timestamps[r][j]))
                    if t.state == TrackingState.LOST and self.on_lost is not None:
                        self.on_lost(t)
        tok = self._dispatch(images, timestamps, host_handled)
        if self._pending is not None:
            out += self._finish(self._pending)
        self._pending = tok
        # robots that recovered on the per-frame path rejoin after the
        # dispatch (their frames of this chunk were handled there)
        for r in host_handled:
            if self.trackers[r].state == TrackingState.OK:
                self.reset_stream(r)
        return out

    def flush(self):
        """Finish the in-flight chunk, if any, and return its records."""
        if self._pending is None:
            return []
        out = self._finish(self._pending)
        self._pending = None
        return out

    def _want_bow(self) -> bool:
        vocs = [t.mapctx.voc for t in self.trackers]
        return (all(v is not None for v in vocs) and all(v is vocs[0] for v in vocs)
                and all(t.mapctx.kf_bow is not None for t in self.trackers))

    def _dispatch(self, images, timestamps, host_handled=frozenset()):
        R, C = len(self.trackers), len(timestamps[0])
        want_bow = self._want_bow()
        if self._step is None or self._step_bow != want_bow:
            # the vocabulary appeared: finish the in-flight chunk before the
            # databases are taken from the trackers
            if self._pending is not None:
                self.flush()
            self._step = make_multistream_chunk_step(self.cfg, self._extract_on,
                                                     with_bow=want_bow)
            self._step_bow = want_bow
            self.bow_all = ([t.mapctx.kf_bow.to(d, copy=True)
                             for t, d in zip(self.trackers, self._devs)] if want_bow else None)
        fid0s = []
        for r, t in enumerate(self.trackers):
            fid0s.append(t.frame_id + 1)
            if r not in host_handled:  # the per-frame path advanced the others
                t.frame_id += C
        stamps = np.asarray(timestamps, np.float32)
        run = [r for r in range(R) if r not in host_handled]
        voc = self.trackers[0].mapctx.voc if want_bow else None
        vocs = [self._voc_on(voc, d) for d in self._devs] if want_bow else [None] * R
        bows = self.bow_all if want_bow else [None] * R
        with stage("bank.chunk"):
            m2, ts2, bow2, summ, evs = self._step(
                [self.m_all[r] for r in run], [self.ts_all[r] for r in run],
                [bows[r] for r in run], [self.K_all[r] for r in run],
                [images[r] for r in run],
                [list(range(fid0s[r], fid0s[r] + C)) for r in run],
                [[float(x) for x in stamps[r]] for r in run],
                [not self.trackers[r].localization_only for r in run], [vocs[r] for r in run])
        summaries, kf_events = [None] * R, [None] * R
        for i, r in enumerate(run):
            self.m_all[r], self.ts_all[r] = m2[i], ts2[i]
            if want_bow:
                self.bow_all[r] = bow2[i]
            summaries[r], kf_events[r] = summ[i], evs[i]
        return {
            "summaries": summaries,
            "kf_events": kf_events,
            "timestamps": np.asarray(timestamps, np.float64),
            "fid0s": fid0s,
            "want_bow": want_bow,
            "gens": list(self._gens),
            "map_ids": [t.mapctx.map_id for t in self.trackers],
            "host_handled": set(host_handled),
        }

    def _finish(self, token):
        """Fetch a dispatched chunk's summaries and run its keyframe-rate
        host events: records, loop closing, merge scans, follower backlog,
        global-BA slices, loss hooks."""
        timestamps = token["timestamps"]
        want_bow = token["want_bow"]
        R, C = len(self.trackers), timestamps.shape[1]
        # the pending global-BA slice costs ride the chunk's fetch
        gba_mcs, seen_mc = [], set()
        for t in self.trackers:
            mc0 = t.mapctx
            if id(mc0) not in seen_mc and mc0._gba_cost_pending is not None:
                seen_mc.add(id(mc0))
                gba_mcs.append(mc0)
        with stage("bank.fetch"):
            s_all, ev_all, gba_costs = _fetch((token["summaries"], token["kf_events"],
                                               [mc0._gba_cost_pending for mc0 in gba_mcs]))
        for mc0, c in zip(gba_mcs, gba_costs):
            mc0._gba_cost_pending = None
            mc0.gba_resolve_cost(float(c))

        all_recs = []
        kfs_per_robot: list[list[tuple[int, int]]] = []  # (slot, j)
        any_kfs = False
        newly_lost: list[int] = []
        for r, t in enumerate(self.trackers):
            recs, new_kfs = [], []
            if r in token["host_handled"]:
                # the per-frame path wrote this robot's records
                kfs_per_robot.append(new_kfs)
                all_recs.append(recs)
                continue
            s = s_all[r]
            stale = token["gens"][r] != self._gens[r]
            A = self._rebase.pop(r, None)  # always consumed, never leaks to a later chunk
            if stale:
                A = None
            mc = t.mapctx
            for j in range(C):
                ok = bool(s.tracking_ok[j])
                n_inl = int(s.n_inliers[j]) if ok else 0
                T_rec = s.T_cw[j] if ok else t.T_cw.cpu().numpy()
                if A is not None and ok:
                    # a loop correction landed after this chunk was
                    # dispatched: its poses ride the corrected keyframe
                    T_rec = T_rec @ A
                if ok and not stale:
                    t.T_cw = self._tensor(T_rec)
                    if bool(s.new_kf[j]):
                        slot = int(s.kf_slot[j])
                        if r not in self.followers:
                            mc.n_kf = max(mc.n_kf, slot + 1)
                        new_kfs.append((slot, j))
                elif not ok and not stale:
                    if t.state != TrackingState.LOST:
                        newly_lost.append(r)
                    t.state = TrackingState.LOST
                ref_slot, T_rel, pend_src = -1, None, None
                if ok:
                    ref_slot, T_rel = int(s.ref_slot[j]), s.T_rel[j]
                    if r in self.followers and ref_slot >= self._follower_base_nkf.get(r, 0):
                        # a copy-local reference keyframe: its slot means
                        # nothing in the authoritative map until replayed
                        pend_src, ref_slot, T_rel = ref_slot, -1, None
                rec = FrameRecord(
                    frame_id=token["fid0s"][r] + j,
                    timestamp=float(timestamps[r][j]),
                    T_cw=T_rec,
                    state=("OK" if ok else "LOST") if stale else t.state.name,
                    n_inliers=n_inl,
                    # stale records belong to the map they were dispatched in
                    map_id=token["map_ids"][r] if stale else mc.map_id,
                    ref_slot=ref_slot,
                    T_rel=T_rel,
                )
                if pend_src is not None:
                    self._pending_ref.setdefault(r, []).append((rec, pend_src, s.T_rel[j]))
                t.frames.append(rec)
                recs.append(rec)
            if not stale:
                self._dirty[r] = self._dirty[r] or bool(new_kfs)
                any_kfs = any_kfs or bool(new_kfs)
            else:
                new_kfs = []
            kfs_per_robot.append(new_kfs)
            all_recs.append(recs)

        if any_kfs:
            # every robot's map context from its slice before any keyframe
            # event runs: a merge scan reads the other robots' maps.
            # Followers' contexts are the shared one, whose authoritative
            # map is the owner's slice
            for r in range(R):
                if self._dirty[r] and r not in self.followers:
                    self._sync_tracker(r)

        for t in self.trackers:
            t._in_chunk_finish = True

        def any_map_switched():
            return any(self.trackers[q].mapctx.map_id != token["map_ids"][q] for q in range(R))

        for r, t in enumerate(self.trackers):
            new_kfs = kfs_per_robot[r]
            if not new_kfs or r in self.followers:
                continue  # a follower's keyframes reach the owner's context at replay
            if t.mapctx.map_id != token["map_ids"][r]:
                continue  # merged away during this finish; reconciled below
            mc = t.mapctx
            if mc.voc is None and t.on_keyframe is None:
                continue
            with stage("bank.kf_events"):
                if want_bow:
                    # BoW rows and loop scans ran in the chunk's phase B
                    ev = ev_all[r]
                    pre = {int(ev.slot[e]): (ev.loop_scores[e], float(ev.loop_min_score[e]))
                           for e in range(len(ev.j)) if ev.j[e] >= 0}
                else:
                    mc.update_bow_rows([slot for slot, _ in new_kfs])
                    pre = mc.loop_scan([slot for slot, _ in new_kfs])
                corrections = []
                merged = False
                for slot, _j in new_kfs:
                    pose_before = mc.map.kf_pose[slot].cpu().numpy()
                    if mc.try_close_loop(slot, t.generator, precomputed=pre.get(slot)):
                        corrections.append((pose_before, mc.map.kf_pose[slot].cpu().numpy()))
                    if t.on_keyframe is not None:
                        t.on_keyframe(t, slot)
                        if any_map_switched():
                            # a merge fired; either side may be this robot.
                            # Reconciliation below pairs and refreshes slices
                            merged = True
                            break
                if not merged and corrections:
                    self._apply_loop_corrections(r, corrections)

        # the deferred merge scan pumps once per chunk; merges fire here
        for t in self.trackers:
            t._in_chunk_finish = False
        if self.on_chunk_end is not None:
            with stage("bank.pump_scans"):
                self.on_chunk_end()
        # merge reconciliation: a robot whose active map changed during this
        # finish (the absorbed side) adopts its new context; robots on the
        # per-frame path rejoin through reset_stream instead
        for r, t in enumerate(self.trackers):
            if r in self.followers or r in token["host_handled"]:
                continue
            if t.state != TrackingState.OK:
                continue
            if t.mapctx.map_id != token["map_ids"][r]:
                self._adopt_merge(r)
        # a merge that absorbed a map no bank robot tracks (a map kept from
        # a loss): the absorbing robot's context keeps its id, but its map
        # was transplanted and moved — refresh the slice and rebase the
        # tracking state through the merge's anchor correction
        for r, t in enumerate(self.trackers):
            reb = t.mapctx.last_merge_rebase
            if reb is None:
                continue
            t.mapctx.last_merge_rebase = None
            if r in self.followers:
                continue
            if any(ow == r for ow in self.followers.values()):
                self._refresh_shared(r, rebase=[reb])
            else:
                self._apply_loop_corrections(r, [reb], refresh_bow=True)
                # the transplant claimed keyframe slots the in-flight chunk
                # may also write: that chunk is stale for this robot
                self._gens[r] += 1
        # follower keyframes gather in a backlog; every REPLAY_INTERVAL
        # chunks a sync point replays them into the authoritative map
        any_backlog = False
        for r, o in list(self.followers.items()):
            slots = [s_ for s_, _j in kfs_per_robot[r]
                     if s_ >= self._follower_base_nkf.get(r, 0)]
            if slots:
                bl = self._follower_backlog.setdefault(r, [])
                bl.extend(s_ for s_ in slots if s_ not in bl)
            if self._follower_backlog.get(r):
                any_backlog = True
        self._chunks_since_sync += 1
        if (any_backlog or self._shared_rebase) and (
                self._chunks_since_sync >= REPLAY_INTERVAL):
            self._want_sync = True
        # overlapped global BA: one slice per scheduled map per chunk,
        # rewriting the robot's current slice (the in-flight chunk's output)
        for r, t in enumerate(self.trackers):
            if r in self.followers:
                continue  # the owner runs the shared map's slices
            mc = t.mapctx
            if mc.gba_remaining > 0:
                with stage("bank.gba_slice"):
                    self._sync_tracker(r)
                    if mc.gba_slice():
                        self.m_all[r] = _copy(mc.map, self._devs[r])
        # loss hooks last, with all state consistent (a hook may switch maps)
        if self.on_lost is not None:
            for r in newly_lost:
                t = self.trackers[r]
                if t.state == TrackingState.LOST:
                    if r in self.followers:
                        self.followers.pop(r, None)
                        self._follower_base_nkf.pop(r, None)
                        self._pending_ref.pop(r, None)
                    elif r in set(self.followers.values()):
                        self._promote_follower_owner(r)
                    self.on_lost(t)
        return all_recs

    def _apply_loop_corrections(self, r: int, corrections, refresh_bow: bool = False):
        """A same-map loop correction (or a merge's anchor correction) moved
        robot ``r``'s map during this finish. The corrected map replaces the
        slice; the TrackState and, while a chunk is in flight, its pending
        record poses are rebased through the corrected keyframe."""
        t = self.trackers[r]
        mc = t.mapctx
        if any(ow == r for ow in self.followers.values()):
            # the owner is rebased now; the followers' copies stay in the
            # old world until the next sync point threads the corrections
            self._shared_rebase.setdefault(r, []).extend(
                [(np.asarray(a), np.asarray(b)) for a, b in corrections])
            self._want_sync = True
        dev = self._devs[r]
        ts_r = self.ts_all[r]
        A = np.eye(4)
        for T_old, T_new in corrections:
            ts_r = fused.rebase_track_state(ts_r, self._tensor(T_old, dev),
                                            self._tensor(T_new, dev))
            A = A @ np.linalg.inv(T_old) @ T_new
        # the correction fused landmarks (the carried indicator is stale) and
        # a transplant may have raised n_kf
        n_kf_new = max(mc.n_kf, int(ts_r.n_kf))
        ts_r = ts_r._replace(obs_ind=ms.lm_indicator(mc.map).to(dev),
                             n_kf=self._i32(n_kf_new, dev),
                             last_kf_T=mc.map.kf_pose[n_kf_new - 1].to(dev, copy=True))
        self.ts_all[r] = ts_r
        self.m_all[r] = _copy(mc.map, dev)
        if refresh_bow and self.bow_all is not None and mc.kf_bow is not None:
            self.bow_all[r] = mc.kf_bow.to(dev, copy=True)
        t.T_cw = self._tensor(t.T_cw.cpu().numpy() @ A)
        t.last_T = t.T_cw
        if self._pending is not None:
            self._rebase[r] = self._rebase.get(r, np.eye(4)) @ A

    def _promote_follower_owner(self, o: int):
        """Owner ``o`` leaves the shared map (loss): its first follower takes
        the authoritative role."""
        members = [r for r, ow in self.followers.items() if ow == o]
        if not members:
            return
        self._sync_tracker(o)  # the authoritative map from the owner's slice
        new_o = members[0]
        self.followers.pop(new_o)
        self._follower_base_nkf.pop(new_o, None)
        # the new owner's copy is replaced by the authoritative map: its
        # un-replayed keyframes and record references die with it
        if self._follower_backlog.pop(new_o, None):
            self._event("bank_backlog_dropped", follower=new_o, owner=o)
        self._pending_ref.pop(new_o, None)
        self._shared_rebase.pop(o, None)
        for r in members[1:]:
            self.followers[r] = new_o
        if o in self._shared_lm_valid:
            self._shared_lm_valid[new_o] = self._shared_lm_valid.pop(o)
        mc = self.trackers[o].mapctx
        dev = self._devs[new_o]
        self.m_all[new_o] = _copy(mc.map, dev)
        # its TrackState against the adopted map: the copy's slot frontier,
        # indicator and associations are invalid there
        ts_n = self.ts_all[new_o]
        base_valid = self._shared_lm_valid.get(new_o)
        last_lm = ts_n.last_lm
        if base_valid is not None:
            safe = torch.clamp_min(last_lm, 0)
            keep = (last_lm >= 0) & base_valid.to(dev)[safe] & mc.map.lm_valid.to(dev)[safe]
            last_lm = torch.where(keep, last_lm, torch.full_like(last_lm, -1))
        ts_n = ts_n._replace(
            n_kf=self._i32(mc.n_kf, dev), obs_ind=ms.lm_indicator(mc.map).to(dev),
            last_lm=last_lm, prev_inliers=torch.zeros_like(ts_n.prev_inliers),
            last_kf_T=mc.map.kf_pose[max(mc.n_kf - 1, 0)].to(dev, copy=True))
        self.ts_all[new_o] = ts_n
        self._gens[new_o] += 1
        self._event("bank_owner_promoted", old_owner=o, new_owner=new_o, map_id=mc.map_id)

    # -- cross-robot merge support ----------------------------------------
    def _adopt_merge(self, r: int):
        """Robot ``r`` was merged into another MapContext during this
        finish. If another bank robot tracks that context, pair them (owner
        and follower) and refresh both slices from the merged map;
        otherwise only robot ``r``'s slice is replaced."""
        t = self.trackers[r]
        owner = None
        for o, to in enumerate(self.trackers):
            if o != r and to.mapctx is t.mapctx:
                owner = self.followers.get(o, o)  # resolve chains
                break
        if t._ts is None:
            t._ts = t._make_ts()
        if owner is None:
            self.m_all[r] = _copy(t.mapctx.map, self._devs[r])
            self.ts_all[r] = _copy(t._ts, self._devs[r])
            self._gens[r] += 1
            return
        self.followers[r] = owner
        self._event("bank_follower", follower=r, owner=owner, map_id=t.mapctx.map_id)
        # the merge's essential graph and GBA slice moved the shared map:
        # the anchor correction goes through the owner's (and any earlier
        # follower's) TrackState
        reb = t.mapctx.last_merge_rebase
        t.mapctx.last_merge_rebase = None
        self._refresh_shared(owner, fresh={r}, rebase=[reb] if reb is not None else None)

    def _refresh_shared(self, o: int, fresh=frozenset(), rebase=None, rebase_skip=frozenset()):
        """Write the authoritative merged map into the owner's and every
        follower's slice and rebuild their TrackStates against it.

        Members not in ``fresh`` take their TrackState from the bank (the
        newest copy); ``fresh`` members keep their host-built state (a newly
        adopted follower's Sim3-moved pose). ``rebase``: (T_kf_old,
        T_kf_new) corrections to thread through every member's TrackState
        except ``rebase_skip``'s."""
        mc = self.trackers[o].mapctx
        ind = ms.lm_indicator(mc.map)
        members = [o] + [r for r, ow in self.followers.items() if ow == o]
        base_valid = self._shared_lm_valid.get(o)
        for r in members:
            t = self.trackers[r]
            # copy-local keyframes die with the copy: its un-replayed backlog
            # and unresolved record references stay frozen
            if r != o:
                if self._follower_backlog.pop(r, None):
                    self._event("bank_backlog_dropped", follower=r, owner=o)
                self._pending_ref.pop(r, None)
            if r not in fresh:
                t._ts = _move(self.ts_all[r], self.device)
                if rebase and r not in rebase_skip:
                    for T_old, T_new in rebase:
                        t._ts = fused.rebase_track_state(t._ts, self._tensor(T_old),
                                                         self._tensor(T_new))
                    t.T_cw = t._ts.T_cw
            if t._ts is None:
                t._ts = t._make_ts()
            last_lm = t._ts.last_lm
            if r != o and r not in fresh and base_valid is not None:
                # landmark ids a follower allocated in its copy name other
                # landmarks in the authoritative pool (both allocate from the
                # same free slots): keep only those alive at the last refresh
                safe = torch.clamp_min(last_lm, 0)
                keep = (last_lm >= 0) & base_valid[safe] & mc.map.lm_valid[safe]
                last_lm = torch.where(keep, last_lm, torch.full_like(last_lm, -1))
            # the collapse gate is disarmed for the first frame after the
            # refresh, for every member: the shared map moved under them
            t._ts = t._ts._replace(
                n_kf=self._i32(mc.n_kf), obs_ind=ind, last_lm=last_lm,
                prev_inliers=torch.zeros_like(t._ts.prev_inliers),
                last_kf_T=mc.map.kf_pose[max(mc.n_kf - 1, 0)].clone())
            t.mapctx = mc
            self._dirty[r] = False
            self._gens[r] += 1
        # every member's slice gets its own copy of the shared map
        for r in members:
            self.m_all[r] = _copy(mc.map, self._devs[r])
            self.ts_all[r] = _copy(self.trackers[r]._ts, self._devs[r])
            if self.bow_all is not None and mc.kf_bow is not None:
                self.bow_all[r] = mc.kf_bow.to(self._devs[r], copy=True)
        # the authoritative pool's occupancy for the next reconciliation's
        # association filter, and the slot mark below which follower copy
        # slots are never replayed
        self._shared_lm_valid[o] = mc.map.lm_valid.clone()
        for r in members:
            if r != o:
                self._follower_base_nkf[r] = mc.n_kf

    def _replay_follower_kfs(self, r: int, o: int, slots: list[int]):
        """Replay follower ``r``'s backlog of copy-local keyframes into the
        authoritative map in one call of ``_replay_kfs_device``. Sync points
        only: the pipeline is drained, so the owner's n_kf is the true slot
        frontier."""
        mc = self.trackers[o].mapctx
        cap = self.cfg.capacity.max_keyframes - 1
        n_allowed = max(0, min(len(slots), cap - mc.n_kf))
        for s_ in slots[n_allowed:]:
            self._event("bank_replay_skipped_capacity", follower=r, slot=int(s_), n_kf=mc.n_kf)
        remap: dict[int, int] = {}  # copy slot -> authoritative slot
        if n_allowed > 0:
            mB = _move(self.m_all[r], self.device)  # the follower's evolved copy
            base_valid = self._shared_lm_valid.get(o)
            if base_valid is None:
                base_valid = mc.map.lm_valid
            want_bow = mc.kf_bow is not None and mc.voc is not None
            take = slots[:n_allowed]
            mc.map, bow2 = _replay_kfs_device(
                self.cfg, mc.map, mc.kf_bow if want_bow else None, mc.voc if want_bow else None,
                mB, take, base_valid, mc.n_kf, n_allowed, want_bow)
            if want_bow:
                mc.kf_bow = bow2
            for i, s_ in enumerate(take):
                remap[int(s_)] = mc.n_kf + i
                self._event("bank_replay_kf", follower=r, owner=o, src_slot=int(s_),
                            dst_slot=mc.n_kf + i)
            mc.n_kf += n_allowed
        # records whose reference keyframe was a copy slot point at its
        # authoritative slot (capacity-skipped slots stay frozen)
        pend = self._pending_ref.pop(r, [])
        rest = []
        for rec, src, T_rel in pend:
            dst = remap.get(src)
            if dst is not None:
                rec.ref_slot = dst
                rec.T_rel = T_rel
            elif src not in [int(x) for x in slots]:
                rest.append((rec, src, T_rel))  # not in this round's backlog
        if rest:
            self._pending_ref[r] = rest

    def _do_shared_sync(self):
        """Sync point (the pipeline is drained): replay every follower's
        backlog into the authoritative map, then refresh every member from
        it, with the owner's accumulated loop corrections threaded through
        the followers."""
        self._want_sync = False
        self._chunks_since_sync = 0
        self.sync_points += 1
        owners = set(self.followers.values()) | set(self._shared_rebase)
        for o in owners:
            if o in self.followers:
                continue  # a stale entry: the owner was demoted or lost
            self._sync_tracker(o)
            with stage("bank.follower_replay"):
                for r, ow in list(self.followers.items()):
                    if ow != o:
                        continue
                    slots = self._follower_backlog.pop(r, [])
                    if slots:
                        self._replay_follower_kfs(r, o, slots)
            reb = self._shared_rebase.pop(o, None)
            with stage("bank.refresh_shared"):
                # the owner was rebased at correction time
                self._refresh_shared(o, rebase=reb, rebase_skip={o})

    def reset_stream(self, r: int):
        """Adopt tracker ``r``'s current host state into the bank: after the
        host handled a loss (new map, reset, relocalization) or a merge
        changed the robot's active map."""
        t = self.trackers[r]
        self.followers.pop(r, None)
        self._follower_base_nkf.pop(r, None)
        self._pending_ref.pop(r, None)  # unresolved references stay frozen
        self._follower_backlog.pop(r, None)
        self._shared_rebase.pop(r, None)
        if t._ts is None:
            t._ts = t._make_ts()
        self.m_all[r] = _copy(t.mapctx.map, self._devs[r])
        self.ts_all[r] = _copy(t._ts, self._devs[r])
        if self.bow_all is not None and t.mapctx.kf_bow is not None:
            self.bow_all[r] = t.mapctx.kf_bow.to(self._devs[r], copy=True)
        self._dirty[r] = False
        self._gens[r] += 1

    def _sync_tracker(self, r: int):
        """Copy robot ``r``'s slice into its MapContext and tracker. A
        follower's copy never overwrites the shared context's authoritative
        map (the owner's slice): only its tracking state is synced."""
        t = self.trackers[r]
        if r not in self.followers:
            t.mapctx.map = _copy(self.m_all[r], self.device)
            if self.bow_all is not None:
                t.mapctx.kf_bow = self.bow_all[r].to(self.device, copy=True)
        t._ts = _copy(self.ts_all[r], self.device)
        self._dirty[r] = False

    def sync_to_trackers(self):
        """Finish the in-flight chunk, reconcile any shared-map backlog, and
        write all device state back into the trackers (trajectory export,
        merging)."""
        self.flush()
        if self._follower_backlog or self._shared_rebase or self._want_sync:
            self._do_shared_sync()
        for r, t in enumerate(self.trackers):
            if t.state == TrackingState.OK:
                self._sync_tracker(r)
                t._sync_from_ts()
