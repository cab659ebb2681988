"""Map state as fixed-capacity structure-of-arrays pools (port of
orbslamm_tpu/models/map_state.py).

Same pools, field names, shapes and dtypes as the JAX ``MapState``, so a map
converts both ways (see ``orbslamm_tpu_torch/convert.py``). Covisibility is
not stored: it is derived from the [K, L] keyframe→landmark indicator.

Mutations are functional like the JAX package's: every function returns a
new ``MapState`` and leaves its input untouched (an updated pool is a fresh
tensor). Masked scatters write into a spare trailing slot that is then cut
off — the eager equivalent of JAX's ``mode="drop"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.ops.orb import Features


class MapState(NamedTuple):
    # --- keyframes [K, ...] ---
    kf_pose: torch.Tensor  # [K,4,4] Tcw
    kf_K: torch.Tensor  # [K,3,3] intrinsics
    kf_valid: torch.Tensor  # [K] bool
    kf_fixed: torch.Tensor  # [K] bool — BA gauge anchor (origin KF)
    kf_frame_id: torch.Tensor  # [K] int32 source frame index
    kf_timestamp: torch.Tensor  # [K] float32 s
    kf_xy: torch.Tensor  # [K,M,2] undistorted pixel coords
    kf_desc: torch.Tensor  # [K,M,32] uint8
    kf_level: torch.Tensor  # [K,M] int32
    kf_angle: torch.Tensor  # [K,M] float32
    kf_feat_valid: torch.Tensor  # [K,M] bool
    kf_obs_lm: torch.Tensor  # [K,M] int32 — landmark id per feature, -1 if none
    kf_ur: torch.Tensor  # [K,M] float32 — stereo right-x per feature, -1 = mono
    # --- landmarks [L, ...] ---
    lm_pos: torch.Tensor  # [L,3] world position
    lm_valid: torch.Tensor  # [L] bool
    lm_desc: torch.Tensor  # [L,32] uint8 representative descriptor
    lm_normal: torch.Tensor  # [L,3] mean viewing direction
    lm_dist_min: torch.Tensor  # [L] scale-invariance band
    lm_dist_max: torch.Tensor  # [L]
    lm_ref_kf: torch.Tensor  # [L] int32 reference keyframe
    lm_first_kf: torch.Tensor  # [L] int32 keyframe that created it
    lm_visible: torch.Tensor  # [L] int32 — times predicted visible
    lm_found: torch.Tensor  # [L] int32 — times actually matched
    loop_edges: torch.Tensor  # [E,2] int32, -1 = empty slot
    n_kf: torch.Tensor  # int32 — high-water mark of allocated KF slots
    n_lm: torch.Tensor  # int32


def empty_map(cfg: SlamConfig, *, device) -> MapState:
    K = cfg.capacity.max_keyframes
    M = cfg.orb.max_keypoints
    L = cfg.capacity.max_landmarks
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=device)
    return MapState(
        kf_pose=torch.eye(4, dtype=f32, **kw).repeat(K, 1, 1),
        kf_K=torch.eye(3, dtype=f32, **kw).repeat(K, 1, 1),
        kf_valid=torch.zeros(K, dtype=torch.bool, **kw),
        kf_fixed=torch.zeros(K, dtype=torch.bool, **kw),
        kf_frame_id=torch.zeros(K, dtype=i32, **kw),
        kf_timestamp=torch.zeros(K, dtype=f32, **kw),
        kf_xy=torch.zeros((K, M, 2), dtype=f32, **kw),
        kf_desc=torch.zeros((K, M, 32), dtype=torch.uint8, **kw),
        kf_level=torch.zeros((K, M), dtype=i32, **kw),
        kf_angle=torch.zeros((K, M), dtype=f32, **kw),
        kf_feat_valid=torch.zeros((K, M), dtype=torch.bool, **kw),
        kf_obs_lm=torch.full((K, M), -1, dtype=i32, **kw),
        kf_ur=torch.full((K, M), -1.0, dtype=f32, **kw),
        lm_pos=torch.zeros((L, 3), dtype=f32, **kw),
        lm_valid=torch.zeros(L, dtype=torch.bool, **kw),
        lm_desc=torch.zeros((L, 32), dtype=torch.uint8, **kw),
        lm_normal=torch.zeros((L, 3), dtype=f32, **kw),
        lm_dist_min=torch.zeros(L, dtype=f32, **kw),
        lm_dist_max=torch.full((L,), 1e9, dtype=f32, **kw),
        lm_ref_kf=torch.zeros(L, dtype=i32, **kw),
        lm_first_kf=torch.zeros(L, dtype=i32, **kw),
        lm_visible=torch.zeros(L, dtype=i32, **kw),
        lm_found=torch.zeros(L, dtype=i32, **kw),
        loop_edges=torch.full((cfg.capacity.max_loop_edges, 2), -1, dtype=i32, **kw),
        n_kf=torch.zeros((), dtype=i32, **kw),
        n_lm=torch.zeros((), dtype=i32, **kw),
    )


# ---------------------------------------------------------------------------
# Masked scatter helpers (the eager form of JAX's ``.at[...].set(mode="drop")``)
# ---------------------------------------------------------------------------

def set_rows(dst: torch.Tensor, idx: torch.Tensor, src, use: torch.Tensor | None = None):
    """Copy of ``dst`` with ``dst[idx[i]] = src[i]`` along dim 0 wherever
    ``use[i]`` (all when None); other entries write nowhere."""
    n = dst.shape[0]
    idx = idx.long()
    if use is not None:
        idx = torch.where(use, idx, torch.full_like(idx, n))
    out = torch.cat([dst, dst[:1]], dim=0)
    src = torch.as_tensor(src, dtype=dst.dtype, device=dst.device)
    out[idx] = src.expand(idx.shape + dst.shape[1:]) if src.ndim < dst.ndim else src
    return out[:n]


def set_row_cols(dst: torch.Tensor, row, cols: torch.Tensor, src, use: torch.Tensor):
    """Copy of the [R, C] ``dst`` with ``dst[row, cols[i]] = src[i]`` wherever
    ``use[i]``."""
    R, C = dst.shape
    flat = torch.cat([dst.reshape(-1), dst.new_zeros(1)])
    pos = torch.as_tensor(row, device=dst.device).long() * C + cols.long()
    pos = torch.where(use, pos, torch.full_like(pos, R * C))
    flat[pos] = torch.as_tensor(src, dtype=dst.dtype, device=dst.device).expand(pos.shape)
    return flat[:-1].reshape(R, C)


def mark(n: int, idx: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """[n] bool, True at ``idx`` wherever ``use``."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    out[torch.where(use, idx.long(), torch.full_like(idx.long(), n))] = True
    return out[:n]


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------

def _indicator_rows(obs: torch.Tensor, feat_valid: torch.Tensor, L: int) -> torch.Tensor:
    """[R, M] observation rows -> [R, L] float32 indicator rows."""
    col = torch.where(feat_valid & (obs >= 0), obs, torch.full_like(obs, L)).long()
    ind = torch.zeros((obs.shape[0], L + 1), dtype=torch.float32, device=obs.device)
    return ind.scatter_(1, col, 1.0)[:, :L]


def lm_indicator(m: MapState) -> torch.Tensor:
    """[K, L] float32 — 1 where keyframe k observes landmark l.

    One formulation: a row scatter into a [K, L+1] table (unobserved
    features land in the spare column). The JAX package switches between a
    compare+reduce and a scatter by problem size, and builds single rows as
    one-hot contractions; both are TPU scatter workarounds."""
    L = m.lm_pos.shape[0]
    return _indicator_rows(m.kf_obs_lm, m.kf_feat_valid, L) * m.kf_valid[:, None]


def indicator_row(m: MapState, slot) -> torch.Tensor:
    """ONE keyframe's [L] observation-indicator row."""
    L = m.lm_pos.shape[0]
    row = _indicator_rows(m.kf_obs_lm[slot][None], m.kf_feat_valid[slot][None], L)[0]
    return row * m.kf_valid[slot]


def refresh_indicator_row(m: MapState, ind: torch.Tensor, slot) -> torch.Tensor:
    """Recompute ONE keyframe's row of the [K,L] indicator."""
    ind = ind.clone()
    ind[slot] = indicator_row(m, slot)
    return ind


def covisibility(m: MapState, ind: torch.Tensor | None = None) -> torch.Tensor:
    """[K, K] int32 — shared-landmark counts, diag zeroed (exact in float32:
    0/1 products summed over at most L < 2^24 terms)."""
    ind = lm_indicator(m) if ind is None else ind
    W = ind @ ind.T
    W = W * (1.0 - torch.eye(W.shape[0], device=W.device))
    return W.to(torch.int32)


def lm_obs_count(m: MapState, ind: torch.Tensor | None = None) -> torch.Tensor:
    """[L] int32 — number of keyframes observing each landmark."""
    ind = lm_indicator(m) if ind is None else ind
    return ind.sum(0).to(torch.int32)


def spanning_parent(m: MapState) -> torch.Tensor:
    """[K] int32 parent = most covisible OLDER keyframe (-1 where none)."""
    W = covisibility(m)
    K = W.shape[0]
    ar = torch.arange(K, device=W.device)
    older = ar[None, :] < ar[:, None]
    Wm = torch.where(older & m.kf_valid[None, :], W, torch.full_like(W, -1))
    parent = torch.argmax(Wm, dim=1).to(torch.int32)
    has = Wm.amax(dim=1) > 0
    return torch.where(has & m.kf_valid, parent, torch.full_like(parent, -1))


# ---------------------------------------------------------------------------
# Mutations (all functional: return a new MapState)
# ---------------------------------------------------------------------------

def insert_keyframe(m: MapState, slot, T_cw, K_mat, feats: Features, obs_lm,
                    frame_id, timestamp, fixed=False) -> MapState:
    """Write one keyframe into ``slot`` (int or int32 scalar tensor)."""
    dev = m.kf_pose.device
    slot = torch.as_tensor(slot, dtype=torch.int32, device=dev)

    def put(dst, value):
        out = dst.clone()
        out[slot] = torch.as_tensor(value, dtype=dst.dtype, device=dev)
        return out

    return m._replace(
        kf_pose=put(m.kf_pose, T_cw),
        kf_K=put(m.kf_K, K_mat),
        kf_valid=put(m.kf_valid, True),
        kf_fixed=put(m.kf_fixed, fixed),
        kf_frame_id=put(m.kf_frame_id, frame_id),
        kf_timestamp=put(m.kf_timestamp, timestamp),
        kf_xy=put(m.kf_xy, feats.xy),
        kf_desc=put(m.kf_desc, feats.desc),
        kf_level=put(m.kf_level, feats.level),
        kf_angle=put(m.kf_angle, feats.angle),
        kf_feat_valid=put(m.kf_feat_valid, feats.valid),
        kf_obs_lm=put(m.kf_obs_lm, torch.where(feats.valid, obs_lm,
                                               torch.full_like(obs_lm, -1))),
        kf_ur=put(m.kf_ur, -1.0 if feats.u_right is None else torch.where(
            feats.valid, feats.u_right, torch.full_like(feats.u_right, -1.0))),
        n_kf=torch.maximum(m.n_kf, slot + 1),
    )


def free_lm_slots(m: MapState, n: int, by_value: bool = False) -> torch.Tensor:
    """[n] int32 indices of free landmark slots (lowest free index first;
    occupied slots only when the pool overflows: lowest first, or with
    ``by_value`` the lowest found ratio first, MapPoint::GetFoundRatio, so a
    merge into a tight pool evicts the worst landmarks)."""
    L = m.lm_valid.shape[0]
    dev = m.lm_valid.device
    if by_value:
        ratio = m.lm_found.to(torch.float32) / torch.clamp_min(
            m.lm_visible.to(torch.float32), 1.0)
        occupied = -1e6 - 1e3 * ratio
    else:
        occupied = torch.full((L,), -1e9, device=dev)
    key = torch.where(m.lm_valid, occupied, -torch.arange(L, dtype=torch.float32, device=dev))
    idx = torch.sort(key, descending=True, stable=True).indices[:n]
    return idx.to(torch.int32)


def add_landmarks(m: MapState, slots, use, pos, desc, normal, dist_min, dist_max,
                  ref_kf) -> MapState:
    """Write landmarks into ``slots`` wherever ``use``; masked entries write
    nowhere."""
    ref = torch.as_tensor(ref_kf, dtype=torch.int32, device=slots.device).expand(slots.shape)
    ones = torch.ones_like(slots)
    upto = torch.where(use, slots + 1, torch.zeros_like(slots)).amax()
    return m._replace(
        lm_pos=set_rows(m.lm_pos, slots, pos, use),
        lm_valid=set_rows(m.lm_valid, slots, True, use),
        lm_desc=set_rows(m.lm_desc, slots, desc, use),
        lm_normal=set_rows(m.lm_normal, slots, normal, use),
        lm_dist_min=set_rows(m.lm_dist_min, slots, dist_min, use),
        lm_dist_max=set_rows(m.lm_dist_max, slots, dist_max, use),
        lm_ref_kf=set_rows(m.lm_ref_kf, slots, ref, use),
        lm_first_kf=set_rows(m.lm_first_kf, slots, ref, use),
        lm_visible=set_rows(m.lm_visible, slots, ones, use),
        lm_found=set_rows(m.lm_found, slots, ones, use),
        n_lm=torch.maximum(m.n_lm, upto.to(torch.int32)),
    )


def keyframe_centers(m: MapState) -> torch.Tensor:
    """[K,3] camera centers (world frame)."""
    R = m.kf_pose[:, :3, :3]
    t = m.kf_pose[:, :3, 3]
    return -torch.einsum("kji,kj->ki", R, t)


def as_numpy_summary(m: MapState) -> dict:
    """Host-side readout for logging (keyframe and landmark counts)."""
    return {"n_kf": int(m.kf_valid.sum()), "n_lm": int(m.lm_valid.sum())}
