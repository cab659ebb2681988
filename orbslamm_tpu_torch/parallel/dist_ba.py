"""Bundle adjustment and feature extraction over a device mesh (port of
orbslamm_tpu/parallel/dist_ba.py).

SURVEY.md §5.7-5.8, §7.1:

  * the observation edges are the data axis of bundle adjustment. Every
    reduction of the edge-list BA (``ops/ba.py``) is a segment sum over
    edges, so the edges are split into contiguous shards, one per mesh
    slot: each shard's residuals, Jacobians and partial normal-equation
    blocks are computed on its own device, the partials are summed on the
    mesh's first device in mesh order, and the small reduced solve runs
    there once. The JAX package gets the same split from GSPMD under an
    edge ``NamedSharding``; its ``edge_sharding`` / ``replicated`` factories
    name those shardings and have no counterpart here;
  * robot streams are data-parallel: image ``s`` of ``[S, H, W]`` is
    extracted on its slot's device;
  * one large map's keyframes are split into blocks over the mesh for the
    global BA: each block's edges and their Jacobians stay on its device,
    and only the [P,3,3], [P,3] and [C,6] partials cross devices (once per
    LM step, and the [P,3] and [C,6] ones once per CG iteration). The
    landmark pool stays whole on the first device, as the JAX package
    replicates it.

The port's meshes here are flat: one axis of slots, in order. The JAX
package names a mesh axis in each ``PartitionSpec`` and may split over one
axis of a 2-D mesh (``host_mesh``'s "chip"); the port splits over every slot
of a 1-D mesh and refuses other meshes. The slots may repeat a device
(``multihost.stream_mesh``): a mesh of four ``cuda:0`` slots runs the
partitioned code on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.ops import ba
from orbslamm_tpu_torch.parallel.multihost import Mesh
from orbslamm_tpu_torch.utils.trace import stage

_EDGE_FIELDS = ("obs_cam", "obs_point", "obs_uv", "obs_sigma2", "obs_valid", "obs_ur")
# MapState fields along the keyframe axis (split into blocks over the mesh);
# the landmark pool, loop edges and counters stay whole on the first device
KF_FIELDS = ("kf_pose", "kf_K", "kf_valid", "kf_fixed", "kf_frame_id", "kf_timestamp", "kf_xy",
             "kf_desc", "kf_level", "kf_angle", "kf_feat_valid", "kf_obs_lm", "kf_ur")


class ShardedBAProblem(NamedTuple):
    """A BAProblem with its edges split over a mesh. ``state`` holds the
    camera and point fields on the mesh's first device (its edge fields are
    None); ``shards[d]`` holds the d-th contiguous block of edges on slot
    d's device (its camera and point fields are None), every block padded
    with ``obs_valid`` False to one length; ``n_edges`` is the unpadded
    count."""

    state: ba.BAProblem
    shards: tuple
    n_edges: int


def _bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous near-equal blocks of ``n`` rows over ``parts`` slots."""
    cuts = [n * i // parts for i in range(parts + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _flat_devices(mesh: Mesh) -> list[torch.device]:
    if len(mesh.axis_names) != 1:
        raise ValueError(f"a flat (1-D) mesh is needed, got axes {mesh.axis_names}")
    return mesh.flat


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def shard_ba_problem(prob: ba.BAProblem, mesh: Mesh) -> ShardedBAProblem:
    """Split ``prob``'s edges into ``len(mesh)`` contiguous shards of equal
    length (padded with invalid edges), each on its slot's device; the
    state lives once, on the mesh's first device."""
    devs = _flat_devices(mesh)
    E = prob.obs_cam.shape[0]
    per = -(-E // len(devs))
    edges = {k: getattr(prob, k) for k in _EDGE_FIELDS}
    shards = []
    for dev, (lo, hi) in zip(devs, [(min(i * per, E), min((i + 1) * per, E))
                                    for i in range(len(devs))]):
        part = {k: None if v is None else _pad(v[lo:hi], per).to(dev) for k, v in edges.items()}
        shards.append(ba.BAProblem(T_cw=None, K=None, cam_valid=None, cam_fixed=None,
                                   points=None, point_valid=None, bf=None, **part))
    state = prob._replace(**{k: None for k in _EDGE_FIELDS})
    state = ba.BAProblem(*(None if v is None else v.to(devs[0]) for v in state))
    return ShardedBAProblem(state=state, shards=tuple(shards), n_edges=E)


def make_distributed_ba(mesh: Mesh, iters: int = 10):
    """Distributed BA step: the edge shards' passes run on their devices,
    their partial Hcc / Hpp / g / W blocks are summed on the mesh's first
    device, and the dense reduced solve runs there. Returns a function
    ShardedBAProblem -> BAResult (on the first device), ``obs_inlier`` in
    the original edge order."""
    dev0 = _flat_devices(mesh)[0]

    def step(sp: ShardedBAProblem) -> ba.BAResult:
        with stage("ba.dense"):
            res = ba.bundle_adjust_shards(sp.state, list(sp.shards), iters=iters)
        inlier = torch.cat([x.to(dev0) for x in res.obs_inlier])[:sp.n_edges]
        return res._replace(obs_inlier=inlier)

    return step


def make_stream_extractor(mesh: Mesh, extract_for):
    """Robot-parallel feature extraction: ``extract_for(device)`` builds an
    extractor on a device (``lambda d: orb.make_extractor(orb_cfg, cam,
    device=d)``), once per distinct slot device. Returns images [S, H, W]
    -> a list of S Features, image ``s`` extracted on slot
    ``s * len(mesh) // S``'s device."""
    devs = _flat_devices(mesh)
    extractors: dict = {}

    def run(images):
        S = len(images)
        out = []
        for s in range(S):
            dev = devs[s * len(devs) // S]
            if dev not in extractors:
                extractors[dev] = extract_for(dev)
            out.append(extractors[dev](images[s]))
        return out

    return run


# ---------------------------------------------------------------------------
# Keyframe-block-sharded global BA (BASELINE §5.7: "maps / keyframe blocks
# sharded across hosts")
# ---------------------------------------------------------------------------

def map_kf_shardings(mesh: Mesh) -> ms.MapState:
    """The MapState placement: the mesh's one axis name on the keyframe-axis
    fields (split into contiguous blocks over the mesh), None on the
    landmark pool, loop edges and counters (whole, on the mesh's first
    device). The landmark state is the shared side that every block's Schur
    reduction sums into (SURVEY.md §5.7)."""
    _flat_devices(mesh)
    axis = mesh.axis_names[0]
    return ms.MapState(**{f: (axis if f in KF_FIELDS else None) for f in ms.MapState._fields})


def shard_map_kf_blocks(m: ms.MapState, mesh: Mesh) -> ms.MapState:
    """Place a MapState as ``map_kf_shardings`` says: each keyframe-axis
    field becomes a tuple of ``len(mesh)`` contiguous blocks, block d on
    slot d's device; every other field is one tensor on the first device.
    ``gather_map_kf_blocks`` is the inverse."""
    spec = map_kf_shardings(mesh)
    devs = _flat_devices(mesh)
    bounds = _bounds(m.kf_pose.shape[0], len(devs))
    out = {}
    for f, where in zip(ms.MapState._fields, spec):
        x = getattr(m, f)
        out[f] = (tuple(x[lo:hi].to(d) for d, (lo, hi) in zip(devs, bounds)) if where
                  else x.to(devs[0]))
    return ms.MapState(**out)


def gather_map_kf_blocks(m: ms.MapState, device) -> ms.MapState:
    """A keyframe-block-sharded MapState as one MapState on ``device``."""
    return ms.MapState(**{f: (torch.cat([b.to(device) for b in x]) if isinstance(x, tuple)
                              else x.to(device)) for f, x in zip(ms.MapState._fields, m)})


def make_kf_sharded_gba(mesh: Mesh, cfg, iters: int = 8, cg_iters: int = 30):
    """Global BA over a keyframe-block-sharded MapState with the matrix-free
    CG solver (``ops/ba.bundle_adjust_cg``) on the map's keyframe-major edge
    list, stereo rows included when ``cfg.camera.bf > 0``. Block d's edges
    are its keyframes' observation rows, built and kept on its device, so
    every per-edge residual and Jacobian and every camera reduction stays
    local to the block; no [W,P] incidence tensor is built. Replaces the
    reference's single-threaded g2o GlobalBundleAdjustemnt (Optimizer.cc:40/59).
    Returns sharded MapState -> sharded MapState (poses and landmark
    positions updated); the result on one device equals
    ``loop_closing.global_bundle_adjust(cfg, m, iters, cg_iters,
    obs_per_kf=M)`` (no compaction)."""
    devs = _flat_devices(mesh)
    dev0 = devs[0]
    stereo = cfg.camera.bf > 0

    def gba(m: ms.MapState) -> ms.MapState:
        if len(m.kf_pose) != len(devs):
            raise ValueError(f"a map in {len(m.kf_pose)} keyframe blocks for a mesh of "
                             f"{len(devs)} slots (shard_map_kf_blocks)")
        kf_pose = torch.cat([b.to(dev0) for b in m.kf_pose])
        kf_valid = torch.cat([b.to(dev0) for b in m.kf_valid])
        K = kf_pose.shape[0]
        shards, k0 = [], 0
        for obs_lm, feat_valid, valid, level, xy, ur in zip(
                m.kf_obs_lm, m.kf_feat_valid, m.kf_valid, m.kf_level, m.kf_xy, m.kf_ur):
            dev = obs_lm.device
            Kb, Mfeat = obs_lm.shape
            lm_idx = torch.clamp_min(obs_lm, 0)
            feat_ok = (feat_valid & (obs_lm >= 0) & valid[:, None]
                       & m.lm_valid.to(dev)[lm_idx.long()])
            sigma2 = (cfg.tracking.pixel_noise
                      * cfg.orb.scale_factor ** level.to(torch.float32)) ** 2
            obs_cam = (k0 + torch.arange(Kb, dtype=torch.int32, device=dev))[:, None].expand(
                Kb, Mfeat)
            shards.append(ba.BAProblem(
                T_cw=None, K=None, cam_valid=None, cam_fixed=None, points=None,
                point_valid=None, obs_cam=obs_cam.reshape(-1),
                obs_point=lm_idx.reshape(-1).to(torch.int32), obs_uv=xy.reshape(-1, 2),
                obs_sigma2=sigma2.reshape(-1), obs_valid=feat_ok.reshape(-1),
                obs_ur=ur.reshape(-1) if stereo else None, bf=None))
            k0 += Kb
        state = ba.BAProblem(
            T_cw=kf_pose, K=torch.cat([b.to(dev0) for b in m.kf_K]), cam_valid=kf_valid,
            cam_fixed=torch.cat([b.to(dev0) for b in m.kf_fixed]), points=m.lm_pos,
            point_valid=m.lm_valid, obs_cam=None, obs_point=None, obs_uv=None,
            obs_sigma2=None, obs_valid=None,
            bf=torch.full((K,), cfg.camera.bf, dtype=torch.float32, device=dev0)
            if stereo else None)
        with stage("ba.global_cg"):
            res = ba.bundle_adjust_cg_shards(state, shards, iters=iters, cg_iters=cg_iters)
        pose = torch.where(kf_valid[:, None, None], res.T_cw, kf_pose)
        blocks = torch.split(pose, [b.shape[0] for b in m.kf_pose])
        return m._replace(kf_pose=tuple(x.to(b.device) for x, b in zip(blocks, m.kf_pose)),
                          lm_pos=res.points)

    return gba
