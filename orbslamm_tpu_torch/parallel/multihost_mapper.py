"""Cross-process MultiMapper coordination, the multi-host deployment of
SURVEY.md §5.8 (port of orbslamm_tpu/parallel/multihost_mapper.py).

The reference's multi-robot coordination is one shared in-process
registry: every System holds a pointer to the same MultiMapper, which walks
all (Map, KFDB) pairs under mutexes (MultiMapper.h:123-130, wired at
src/MultiMapper.cc:925-946). Across hosts there is no shared memory, so the
registry becomes host-replicated metadata plus payload migration:

  * every process runs its own robots and MultiMapper (robot streams are
    host-parallel: nothing crosses hosts on the tracking path);
  * a ``HostMapperBridge`` periodically exchanges compact per-map BoW
    signatures (the top-scoring words of the newest keyframes) through one
    ``all_gather_bytes`` collective: the registry scan of
    MultiMapper.cc:82-165, between processes;
  * when a remote signature scores against a local keyframe database, the
    owning process ships the candidate map (a second and third collective
    round), and the receiving MultiMapper registers it like a local map:
    its deferred scan, Sim3 verification and merge (``models/multimap.py``)
    then do the actual merge. The imported map lands on the receiving
    process's device;
  * the vocabulary is broadcast once from process 0
    (``multihost.broadcast_pytree`` of ``convert.vocabulary_to_numpy``) so
    BoW word ids agree across hosts (the reference loads the same ORBvoc.txt
    in every System).

``exchange()`` is collective: every process calls it the same number of
times (from a lockstep outer loop, e.g. once per chunk round: the cadence
of the MultiMapper thread's 5 ms poll).

Shipping: a map still tracked by a local robot ships as a copy (the robot
keeps mapping it; the receiver merges the copy, a one-way contribution like
a robot uploading to a map server). An orphan map (kept after a loss, or
whose robot finished) migrates and is retired locally.

Payloads are pickled dicts of numpy arrays (``convert.map_state_to_numpy``),
never tensors. ``events`` lists what the bridge did as (name, fields):
``multihost_map_received``, ``multihost_map_migrated`` and
``multihost_map_copied``; ``exchange`` runs in the ``multihost.exchange``
stage.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.models.multimap import MultiMapper
from orbslamm_tpu_torch.models.system import MapContext
from orbslamm_tpu_torch.ops import bow
from orbslamm_tpu_torch.parallel import multihost as mh
from orbslamm_tpu_torch.utils.trace import get_tracer, stage


def _sparsify_rows(rows: np.ndarray, top_w: int):
    """[R, n_words] dense BoW rows -> (word_idx [R, top_w], weights): the
    compact signature payload (BoW vectors are naturally sparse)."""
    idx = np.argsort(rows, axis=1)[:, -top_w:].astype(np.int32)
    w = np.take_along_axis(rows, idx, axis=1).astype(np.float32)
    return idx, w


def _densify_rows(idx, w, n_words: int) -> np.ndarray:
    rows = np.zeros((idx.shape[0], n_words), np.float32)
    np.put_along_axis(rows, idx, w, axis=1)
    return rows


class HostMapperBridge:
    """Periodic cross-process map-signature exchange and payload
    migration for one process's MultiMapper."""

    def __init__(self, mm: MultiMapper, reps_per_map: int = 6, top_words: int = 64,
                 score_floor: float = 0.02, payload_max: int = 1 << 23):
        self.mm = mm
        self.reps_per_map = reps_per_map
        self.top_words = top_words
        self.score_floor = score_floor
        self.payload_max = payload_max
        self.process_id = mh.process_index()
        self.n_proc = mh.process_count()
        # (proc, map_id) pairs already received: never imported twice
        self._imported: set[tuple[int, int]] = set()
        # local ids of maps that came from another process: never announced
        # back (echo guard) and never shipped again
        self._imported_local: set[int] = set()
        self._shipped: set[int] = set()
        self.transfers: list[dict] = []
        self.events: list[tuple[str, dict]] = []

    def _event(self, name: str, **fields):
        """Record a bridge event here (counted per bridge) and in the
        process Tracer."""
        self.events.append((name, fields))
        get_tracer().event(name, **fields)

    def count(self, name: str) -> int:
        """How many events of ``name`` the bridge has recorded."""
        return sum(1 for n, _ in self.events if n == name)

    # -- signature construction -------------------------------------------
    def _local_signatures(self) -> list[dict]:
        sigs = []
        cfg = self.mm.cfg
        for mc in self.mm.live_maps():
            if mc.kf_bow is None or mc.n_kf < cfg.loop.min_kfs_for_merge:
                continue
            if mc.map_id in self._shipped or mc.map_id in self._imported_local:
                continue
            # the newest reps_per_map keyframes are the map's signature (the
            # reference scans newest first, MultiMapper.cc:124)
            slots = list(range(max(0, mc.n_kf - self.reps_per_map), mc.n_kf))
            rows = mc.kf_bow[slots].cpu().numpy()
            idx, w = _sparsify_rows(rows, self.top_words)
            sigs.append({"map_id": mc.map_id, "n_kf": mc.n_kf, "slots": slots,
                         "word_idx": idx, "word_w": w})
        return sigs

    def _score_remote(self, sig: dict) -> float:
        """Best BoW score of a remote map signature against every local
        map's keyframe database (KeyFrameDatabase::DetectLoopCandidates
        across processes)."""
        best = 0.0
        for mc in self.mm.live_maps():
            if mc.kf_bow is None or mc.n_kf < 2:
                continue
            rows = _densify_rows(sig["word_idx"], sig["word_w"], int(mc.kf_bow.shape[1]))
            kv = mc.map.kf_valid.cpu().numpy()
            for r in rows:
                s = bow.bow_score(torch.as_tensor(r, device=mc.kf_bow.device),
                                  mc.kf_bow).cpu().numpy()
                best = max(best, float(np.where(kv, s, -1.0).max()))
        return best

    # -- payload (de)serialization ----------------------------------------
    def _pack_map(self, mc: MapContext) -> bytes:
        payload = {
            "map_id": mc.map_id,
            "n_kf": mc.n_kf,
            "map": convert.map_state_to_numpy(mc.map),
            "kf_bow": None if mc.kf_bow is None else mc.kf_bow.cpu().numpy(),
        }
        return pickle.dumps(payload)

    def _unpack_map(self, blob: bytes, src_proc: int) -> MapContext | None:
        payload = pickle.loads(blob)
        key = (src_proc, payload["map_id"])
        if key in self._imported:
            return None
        self._imported.add(key)
        mc = MapContext(self.mm.cfg, voc=self.mm.voc, device=self.mm.device)
        self._imported_local.add(mc.map_id)
        mc.map = convert.map_state_from_numpy(payload["map"], device=self.mm.device)
        mc.n_kf = payload["n_kf"]
        if payload["kf_bow"] is not None:
            mc.kf_bow = convert.kf_bow_from_numpy(payload["kf_bow"], device=self.mm.device)
        self.mm.maps.append(mc)
        self._event("multihost_map_received", src_proc=src_proc, src_map=payload["map_id"],
                    local_map=mc.map_id, n_kf=mc.n_kf)
        # feed the local merge pipeline: the imported map's newest keyframes
        # are queued for the cross-map scan
        for s in range(max(0, mc.n_kf - self.reps_per_map), mc.n_kf):
            self.mm.enqueue_scan(mc, s)
        return mc

    def _is_tracked(self, mc: MapContext) -> bool:
        return any(r.mapctx is mc for r in self.mm.robots)

    # -- the collective ----------------------------------------------------
    def exchange(self) -> int:
        """One collective exchange round (every process calls it):
        signatures out, candidate payloads back. Returns the number of maps
        imported into the local MultiMapper this round."""
        if self.n_proc == 1:
            return 0
        with get_tracer().span("multihost_exchange"), stage("multihost.exchange"):
            sigs = self._local_signatures()
            meta = [{"map_id": s["map_id"], "n_kf": s["n_kf"]} for s in sigs]
            packets = mh.all_gather_bytes(pickle.dumps({"sigs": sigs, "meta": meta}),
                                          max_len=1 << 20)
            all_sigs = [pickle.loads(p) for p in packets]
            # score the remote signatures against the local databases and
            # request the remote maps that look like merge candidates
            wanted: list[tuple[int, int]] = []  # (proc, map_id)
            for p, pack in enumerate(all_sigs):
                if p == self.process_id:
                    continue
                for sig in pack["sigs"]:
                    if (p, sig["map_id"]) in self._imported:
                        continue
                    if self._score_remote(sig) >= self.score_floor:
                        wanted.append((p, sig["map_id"]))
            # second round: publish the requests; then ship every map that
            # another process requested (the requester imports it; the owner
            # retires it unless a local robot still tracks it)
            req_packets = mh.all_gather_bytes(pickle.dumps(wanted), max_len=1 << 16)
            all_wanted = [pickle.loads(p) for p in req_packets]
            to_ship = []
            for p, reqs in enumerate(all_wanted):
                if p == self.process_id:
                    continue
                for proc, mid in reqs:
                    if proc == self.process_id and mid not in self._shipped:
                        mc = next((m for m in self.mm.maps
                                   if m.map_id == mid and m.merged_into is None), None)
                        if mc is not None:
                            to_ship.append(mc)
            blob = pickle.dumps([self._pack_map(mc)
                                 for mc in {id(m): m for m in to_ship}.values()])
            payloads = mh.all_gather_bytes(blob, max_len=self.payload_max)
            n_imported = 0
            for p, pl in enumerate(payloads):
                if p == self.process_id:
                    continue
                for b in pickle.loads(pl):
                    if self._unpack_map(b, p) is not None:
                        n_imported += 1
            for mc in to_ship:
                self._shipped.add(mc.map_id)
                tracked = self._is_tracked(mc)
                if not tracked:
                    # an orphan migrates outright: retired locally
                    mc.merged_into = mc  # self-sentinel: out of the live rotation
                    self._event("multihost_map_migrated", map_id=mc.map_id)
                else:
                    self._event("multihost_map_copied", map_id=mc.map_id)
                self.transfers.append({"map_id": mc.map_id, "tracked": tracked})
        return n_imported

    def pump(self, rounds: int = 3) -> bool:
        """``exchange`` and then the local merge pipeline, to verify the
        imported candidates. Returns True if a merge happened locally."""
        self.exchange()
        merged = False
        for _ in range(rounds):
            merged = self.mm.pump_merge_scans() or merged
        return merged
