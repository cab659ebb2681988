"""Config system (the port's copy of ``orbslamm_tpu/utils/config.py``).

Mirrors the reference's three-layer config (SURVEY.md §5.6): per-dataset YAML
settings files with cv::FileStorage keys (``Camera.fx`` …, ``ORBextractor.*``;
reference Tracking.cc:52-148), plus the hard-coded algorithm constants that
the reference buries at use sites (ORBmatcher.cc:37-39, KeyFrame.cc:355,
Optimizer.cc:1110, MultiMapper.cc:214,306,362) — here they are all explicit,
named fields so they can be tuned and logged.

Capacity fields fix the size of every pool (features per frame, keyframes
per map, landmarks per map, maps per system), so that every tensor of a
session keeps its shape.

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_package.py`` holds the two copies equal. Port functions
only read attributes of a config, so either package's ``SlamConfig`` works.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole + radial-tangential distortion (reference YAML Camera.*)."""

    fx: float = 520.9
    fy: float = 521.0
    cx: float = 325.1
    cy: float = 249.7
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    rgb: int = 1
    width: int = 640
    height: int = 480
    # stereo / RGB-D (reference YAML Camera.bf, ThDepth, DepthMapFactor —
    # e.g. Examples/RGB-D settings; Tracking.cc:100-117 reads them)
    bf: float = 0.0  # baseline [m] × fx [px] — 0 means monocular
    th_depth: float = 40.0  # close/far cutoff = bf*th_depth/fx meters
    depth_map_factor: float = 5000.0  # raw depth units per meter (TUM PNGs)

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0

    @property
    def close_depth(self) -> float:
        """Depth below which a single observation is trusted (mThDepth)."""
        return self.bf * self.th_depth / self.fx if self.fx else 0.0

    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclass(frozen=True)
class OrbConfig:
    """ORB extraction settings (reference YAML ORBextractor.*)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # TPU shape capacities (>= 2*n_features: the init extractor uses a 2N
    # budget, reference Tracking.cc:120-126)
    max_keypoints: int = 2048
    cell_size: int = 16  # selection grid cell in level-0 pixels
    # two-view-init extraction budget; 0 = the reference's 2*nFeatures
    # policy (Tracking.cc:122). Raise it when wide-baseline feature
    # SELECTION churn (not matching) caps init matches — the 100-match bar
    # needs the same structure re-selected across the init baseline.
    init_features: int = 0


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (reference ORBmatcher.cc:37-39)."""

    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30  # rotation-consistency histogram bins
    nn_ratio_tracking: float = 0.9
    nn_ratio_init: float = 0.9


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end thresholds (reference Tracking.cc)."""

    min_matches_init: int = 100  # SearchForInitialization acceptance (Tracking.cc:640)
    init_min_triangulated: int = 50  # ReconstructF minTriangulated; scale with
    # the feature budget (reference assumes a 2N=2000-feature init extractor)
    init_min_parallax_deg: float = 1.0  # ReconstructF minParallax
    min_inliers_track: int = 10  # post-PoseOptimization survival (Tracking.cc:905)
    min_matches_motion: int = 20  # TrackWithMotionModel acceptance (Tracking.cc:960)
    min_inliers_local_map: int = 30  # TrackLocalMap acceptance (Tracking.cc:1015)
    min_track_inlier_ratio: float = 0.25  # inliers/associations floor — rejects
    # perceptual-aliasing frames whose chance matches pass counts but not ratio
    new_kf_min_frames: int = 0
    new_kf_max_frames: int = 30  # mMaxFrames = fps (Tracking.cc:1060)
    new_kf_tracked_ratio: float = 0.9  # thRefRatio (Tracking.cc:1105)
    min_kfs_for_new_map: int = 10  # early-loss → full reset instead (Tracking.cc:520)
    search_radius_motion: float = 15.0  # th for SearchByProjection motion model
    search_radius_local: float = 3.0
    pixel_noise: float = 1.0  # base measurement sigma at octave 0 (px);
    # the reference hard-codes 1.0 via invSigma2 — synthetic imagery with
    # integer-pinned sprites needs ~1.5


@dataclass(frozen=True)
class MappingConfig:
    """Local mapping / culling thresholds (reference LocalMapping.cc)."""

    culling_found_ratio: float = 0.25  # MapPointCulling (LocalMapping.cc:183)
    culling_min_obs: int = 3
    kf_culling_redundancy: float = 0.9  # KeyFrameCulling (LocalMapping.cc:632)
    covisibility_weight_min: int = 15  # KeyFrame.cc:355
    triangulation_neighbors: int = 20  # CreateNewMapPoints (LocalMapping.cc:215)
    local_ba_window: int = 20  # covisible KFs in local BA


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing / multi-map merge thresholds (LoopClosing.cc, MultiMapper.cc)."""

    covisibility_consistency: int = 3  # LoopClosing.cc:43
    min_bow_matches: int = 15  # MultiMapper.cc:214 / LoopClosing ComputeSim3
    min_sim3_inliers: int = 20  # MultiMapper.cc:306
    min_total_matches: int = 40  # MultiMapper.cc:362
    min_kfs_for_merge: int = 10  # MultiMapper.cc:112
    kfs_between_loops: int = 10  # LoopClosing.cc:115
    essential_graph_min_weight: int = 100  # Optimizer.cc:1110
    # candidate scan breadth: top-k covisibility-GROUP representatives are
    # geometrically verified, not just the raw argmax (KFDB retains every
    # group within 0.75x of the best, KeyFrameDatabase.cc:188-198)
    top_k_candidates: int = 3
    # merge rescan: older keyframes of the newer map re-queried per scan
    # call, newest→oldest (the reference walks ALL of map B's keyframes
    # against the base KFDB, MultiMapper.cc:124)
    merge_rescan_per_kf: int = 2
    # on-device vocabulary training parameters (used when no pretrained
    # vocabulary file is given; the reference always loads a pretrained
    # ~1M-word ORBvoc.txt — pass SlamConfig.vocabulary_path for that).
    # 10^4-word production training = branching 10, depth 4.
    vocab_branching: int = 8
    vocab_depth: int = 3
    vocab_iters: int = 6


@dataclass(frozen=True)
class CapacityConfig:
    """Static pool capacities — the fixed-shape contract of all jitted code."""

    max_keyframes: int = 512  # per map
    max_landmarks: int = 16384  # per map
    max_obs_per_landmark: int = 32
    max_maps: int = 8
    max_local_kfs: int = 80  # Tracking.cc:1348 local-window cap
    max_local_points: int = 4096
    # persistent loop-edge table (KeyFrame::AddLoopEdge records)
    max_loop_edges: int = 32


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    multi_mapping: bool = True  # ORBSLAMM mode: new map on loss + merge
    sensor: str = "mono"  # "mono" | "stereo" | "rgbd" (System eSensor analog)
    # pretrained DBoW2 text vocabulary (the reference CLI's first positional
    # argument, README.md:117-124); None = train on-device from session
    # descriptors (LoopConfig.vocab_* parameters)
    vocabulary_path: str | None = None

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# cv::FileStorage-style YAML loading (the reference's settings format)
# ---------------------------------------------------------------------------

def _parse_opencv_yaml(text: str) -> dict:
    """Parse an OpenCV FileStorage YAML (``%YAML:1.0`` header, ``Key.sub: v``
    flat keys). Returns a flat {key: float} dict. PyYAML rejects the OpenCV
    header, so this is a tolerant line parser for the subset the reference
    uses (scalar keys only — e.g. Examples/Monocular/TUM2.yaml)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("%") or line.startswith("---"):
            continue
        m = re.match(r"^([\w.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip().strip('"')
        try:
            out[key] = float(val)
        except ValueError:
            out[key] = val  # type: ignore[assignment]
    return out


def load_settings(path: str | Path, base: SlamConfig | None = None) -> SlamConfig:
    """Load a reference-format settings YAML into a SlamConfig.

    Accepts the exact files the reference ships (TUM1/2/3, KITTI00-02, …).
    """
    raw = _parse_opencv_yaml(Path(path).read_text())
    cfg = base or SlamConfig()

    def g(key, default):
        return type(default)(raw.get(key, default))

    cam = CameraConfig(
        fx=g("Camera.fx", cfg.camera.fx),
        fy=g("Camera.fy", cfg.camera.fy),
        cx=g("Camera.cx", cfg.camera.cx),
        cy=g("Camera.cy", cfg.camera.cy),
        k1=g("Camera.k1", cfg.camera.k1),
        k2=g("Camera.k2", cfg.camera.k2),
        p1=g("Camera.p1", cfg.camera.p1),
        p2=g("Camera.p2", cfg.camera.p2),
        k3=g("Camera.k3", cfg.camera.k3),
        fps=g("Camera.fps", cfg.camera.fps),
        rgb=int(raw.get("Camera.RGB", cfg.camera.rgb)),
        width=int(raw.get("Camera.width", cfg.camera.width)),
        height=int(raw.get("Camera.height", cfg.camera.height)),
        bf=g("Camera.bf", cfg.camera.bf),
        th_depth=g("ThDepth", cfg.camera.th_depth),
        depth_map_factor=g("DepthMapFactor", cfg.camera.depth_map_factor),
    )
    n_feat = int(raw.get("ORBextractor.nFeatures", cfg.orb.n_features))
    orb = dataclasses.replace(
        cfg.orb,
        n_features=n_feat,
        scale_factor=g("ORBextractor.scaleFactor", cfg.orb.scale_factor),
        n_levels=int(raw.get("ORBextractor.nLevels", cfg.orb.n_levels)),
        ini_th_fast=int(raw.get("ORBextractor.iniThFAST", cfg.orb.ini_th_fast)),
        min_th_fast=int(raw.get("ORBextractor.minThFAST", cfg.orb.min_th_fast)),
        max_keypoints=max(cfg.orb.max_keypoints, _next_pow2(n_feat)),
    )
    # init acceptance thresholds scale with the feature budget: the
    # reference's fixed counts (Tracking.cc:640 nmatches<100,
    # Initializer minTriangulated 50) assume its 1000/2000-feature
    # configurations — at smaller budgets the same absolute counts are
    # unreachable and initialization never fires
    fscale = min(1.0, n_feat / 1000.0)
    tracking = dataclasses.replace(
        cfg.tracking,
        new_kf_max_frames=int(cam.fps) if cam.fps > 0 else 30,
        min_matches_init=max(
            40, int(round(cfg.tracking.min_matches_init * fscale))
        ),
        init_min_triangulated=max(
            25, int(round(cfg.tracking.init_min_triangulated * fscale))
        ),
        # framework-extension keys (not in the reference schema; optional)
        pixel_noise=g("Tracking.pixelNoise", cfg.tracking.pixel_noise),
        init_min_parallax_deg=g(
            "Tracking.initMinParallaxDeg", cfg.tracking.init_min_parallax_deg
        ),
    )
    return dataclasses.replace(cfg, camera=cam, orb=orb, tracking=tracking)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
