"""State converters between numpy and this package's tensors.

These carry the system's state across: a ``MapState``/``Features``/
``TrackState``/``FrameSummary``/``ChunkKFEvents``/``PoseGraphProblem``/
``BAProblem`` of the JAX package, after ``np.asarray`` on each field (or a
dict of such arrays), becomes this package's NamedTuple on a named device,
and back to a dict of numpy arrays that rebuilds the JAX NamedTuple with
``jax_type(**d)``. A ``Vocabulary`` goes through a dict of its arrays
plus ``branching`` and ``depth``; the keyframe BoW database is one
[K, n_words] float32 array. Field names, shapes and dtypes (int32, uint8,
bool, float32) are the same on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslamm_tpu_torch.models.fused import ChunkKFEvents, FrameSummary, TrackState
from orbslamm_tpu_torch.models.map_state import MapState
from orbslamm_tpu_torch.ops import bow
from orbslamm_tpu_torch.ops.ba import BAProblem, PoseGraphProblem
from orbslamm_tpu_torch.ops.orb import Features


def _fields(x) -> dict:
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


def _tensor(a, device):
    a = None if a is None else np.asarray(a)
    if a is None or (a.dtype == object and a.ndim == 0 and a.item() is None):
        return None  # an absent optional field (np.asarray(None))
    return torch.as_tensor(np.array(a), device=device)


def _numpy(t):
    return None if t is None else t.detach().cpu().numpy()


def features_from_numpy(f, *, device) -> Features:
    d = _fields(f)
    return Features(**{k: _tensor(d.get(k), device) for k in Features._fields})


def features_to_numpy(f: Features) -> dict:
    return {k: _numpy(v) for k, v in f._asdict().items()}


def map_state_from_numpy(m, *, device) -> MapState:
    d = _fields(m)
    return MapState(**{k: _tensor(d[k], device) for k in MapState._fields})


def map_state_to_numpy(m: MapState) -> dict:
    return {k: _numpy(v) for k, v in m._asdict().items()}


def track_state_from_numpy(ts, *, device) -> TrackState:
    d = _fields(ts)
    out = {k: _tensor(d[k], device) for k in TrackState._fields if k != "last_feats"}
    return TrackState(last_feats=features_from_numpy(d["last_feats"], device=device), **out)


def track_state_to_numpy(ts: TrackState) -> dict:
    d = {k: _numpy(v) for k, v in ts._asdict().items() if k != "last_feats"}
    d["last_feats"] = features_to_numpy(ts.last_feats)
    return d


def _tuple_from_numpy(kind, x, device):
    d = _fields(x)
    return kind(**{k: _tensor(d.get(k), device) for k in kind._fields})


def _tuple_to_numpy(x) -> dict:
    return {k: _numpy(v) for k, v in x._asdict().items()}


def frame_summary_from_numpy(s, *, device) -> FrameSummary:
    return _tuple_from_numpy(FrameSummary, s, device)


def pose_graph_from_numpy(p, *, device) -> PoseGraphProblem:
    return _tuple_from_numpy(PoseGraphProblem, p, device)


def ba_problem_from_numpy(p, *, device) -> BAProblem:
    return _tuple_from_numpy(BAProblem, p, device)


def chunk_kf_events_from_numpy(e, *, device) -> ChunkKFEvents:
    return _tuple_from_numpy(ChunkKFEvents, e, device)


frame_summary_to_numpy = chunk_kf_events_to_numpy = _tuple_to_numpy
pose_graph_to_numpy = ba_problem_to_numpy = _tuple_to_numpy


def vocabulary_from_numpy(v, *, device) -> bow.Vocabulary:
    """A vocabulary from a dict (or object) with ``nodes``, ``idf``,
    ``branching``, ``depth`` and optional ``node_valid``."""
    d = v if isinstance(v, dict) else {k: getattr(v, k) for k in
                                       ("nodes", "idf", "branching", "depth", "node_valid")}
    nv = d.get("node_valid")
    return bow.vocabulary_from_numpy(np.asarray(d["nodes"]), np.asarray(d["idf"]),
                                     int(d["branching"]), int(d["depth"]),
                                     None if nv is None else np.asarray(nv), device=device)


def vocabulary_to_numpy(voc: bow.Vocabulary) -> dict:
    return {"nodes": _numpy(voc.nodes), "idf": _numpy(voc.idf), "branching": voc.branching,
            "depth": voc.depth, "node_valid": _numpy(voc.node_valid)}


def kf_bow_from_numpy(a, *, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)
