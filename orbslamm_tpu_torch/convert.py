"""State converters between numpy and this package's tensors.

The map is the system's only state, so these carry it across: a
``MapState``/``Features``/``TrackState`` of the JAX package, after
``np.asarray`` on each field (or a dict of such arrays), becomes this
package's NamedTuple on a named device, and back to a dict of numpy arrays
that rebuilds the JAX NamedTuple with ``jax_type(**d)``. Field names,
shapes and dtypes (int32, uint8, bool, float32) are the same on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslamm_tpu_torch.models.fused import TrackState
from orbslamm_tpu_torch.models.map_state import MapState
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
