"""Configuration layer for pislam-tpu.

The reference has no config system: everything is a compile-time template
parameter (vstep/border/logBucketSize/bucketLimit/words, reference
Fast.h:54,196, Orb.h:396) plus two runtime thresholds (demo.cpp:85-86) and a
hardcoded pyramid level table (demo.cpp:38-47). Here those become real,
serialisable dataclasses; everything that shapes traced programs is static.

This is a verbatim copy of ``pislam_tpu/config.py``: the port cannot import
``pislam_tpu`` without importing jax. tests/test_torch_config_tables.py pins
it field for field to the JAX package's dataclasses.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def demo_level_sizes(
    base_width: int = 640,
    base_height: int = 480,
    num_levels: int = 8,
    inv_scale: float = 5.0 / 6.0,
) -> Tuple[Tuple[int, int], ...]:
    """Pyramid level table: round(base * (5/6)**level).

    Reproduces the reference demo's hardcoded table exactly
    (reference demo.cpp:38-47: 640x480, 533x400, 444x333, 370x278,
    309x231, 257x193, 214x161, 179x134).
    """
    out = []
    for lvl in range(num_levels):
        s = inv_scale**lvl
        out.append((int(round(base_width * s)), int(round(base_height * s))))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Geometry of the stacked image pyramid.

    The pyramid is a single vertically stacked (total_height, stride) uint8
    buffer, levels top to bottom, each level left-aligned at column 0 (the
    reference's layout, README.md:56-83). ``stride`` is the padded width
    (lane-friendly multiple of 128); ``padded_height`` rounds the stack to a
    sublane-friendly multiple of 8.
    """

    base_width: int = 640
    base_height: int = 480
    num_levels: int = 8
    inv_scale: float = 5.0 / 6.0

    @property
    def level_sizes(self) -> Tuple[Tuple[int, int], ...]:
        return demo_level_sizes(
            self.base_width, self.base_height, self.num_levels, self.inv_scale
        )

    @property
    def level_rows(self) -> Tuple[int, ...]:
        """Starting row of each level within the stacked buffer."""
        rows, y = [], 0
        for _, h in self.level_sizes:
            rows.append(y)
            y += h
        return tuple(rows)

    @property
    def total_height(self) -> int:
        return sum(h for _, h in self.level_sizes)

    @property
    def stride(self) -> int:
        return round_up(self.base_width, 128)

    @property
    def padded_height(self) -> int:
        return round_up(self.total_height, 8)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """ORB frontend parameters.

    Defaults mirror the reference demo (demo.cpp:85-89): FAST threshold 20,
    Harris threshold 1<<15, border 16, no bucketing, 8-word (256-bit)
    descriptors. ``max_keypoints`` is the fixed keypoint capacity (XLA needs
    static shapes; the variable-length std::vector of the reference becomes a
    top-K tensor with a validity mask).
    """

    fast_threshold: int = 20
    harris_threshold: int = 1 << 15
    border: int = 16
    log_bucket_size: int = 0  # 0 disables spatial bucketing (demo default)
    bucket_limit: int = 5
    words: int = 8
    # Fixed keypoint capacity. 2048 covers the reference's whole realistic
    # operating envelope (~1000-1900 features at its demo thresholds,
    # README.md:99-101 "comfortably handle up to 2000"); raise for
    # low-threshold configs. Per-frame cost scales with this capacity.
    max_keypoints: int = 2048
    # Run FAST+Harris+NMS+encode as one fused Pallas pass instead of XLA
    # dense ops (2.7x faster in isolation and ~10-30% faster in-context
    # alongside the Pallas BRIEF kernel; interleaved A/B via
    # tools/ab_frontend.py). Bit-exact either way; the XLA path remains the
    # oracle and the CPU/bucketed fallback.
    fused_upstream: bool = True
    # BRIEF rotation-select kernel: "dense" runs all 30 rotation matmuls
    # per block and selects (pallas_kernels.orb_select_bits); "sorted"
    # computes angles first, sorts keypoints by bin and skips rotations
    # outside each block's bin range (orb_select_bits_sorted). Bit-exact
    # either way (asserted on hardware, tools/ab_orb_sort.py). Measured on
    # the demo pyramid: isolated stage 0.121 vs 0.114 ms (~6%), but
    # IN-CONTEXT the full frontend runs 0.541 vs 0.326 ms/frame (1.66x) --
    # the dense variant's ~30x MXU over-work crowds out the rest of the
    # pipeline (interleaved A/B, tools/ab_frontend.py 2026-08-17).
    brief_variant: str = "sorted"

    def __post_init__(self):
        assert self.border >= 16, "border must cover FAST(3)+Harris(4)+ORB(15)"
        assert 1 <= self.words <= 8
        assert self.brief_variant in ("dense", "sorted")


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Brute-force Hamming matcher parameters."""

    max_distance: int = 64  # max Hamming distance for a valid match
    ratio: float = 0.8  # Lowe ratio test threshold (second-best filtering)
    cross_check: bool = True


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Frame-to-frame visual odometry (RANSAC essential matrix)."""

    ransac_iters: int = 256  # vmapped hypotheses (fixed shape)
    sample_size: int = 8  # 8-point algorithm
    inlier_threshold: float = 1.5e-3  # Sampson distance in normalised coords
    min_inliers: int = 15
    # E/H model selection during BOOTSTRAP (the ORB-SLAM monocular
    # initialiser rule, geometry/homography.select_model): while only the
    # bootstrap keyframe exists, run both RANSACs and take the homography
    # pose when its inlier share wins. Motivation: the essential solve is
    # degenerate on near-planar/low-parallax bootstrap views -- measured
    # on the committed sequences, E returns 100% inlier support with a
    # 76-86 deg WRONG translation direction on eval_seq/2/4's bootstrap
    # pair. Default OFF because H is not reliably better on this scene
    # family (threshold sweep, frame 3 t-direction error vs gt:
    # eval_seq2 E 77d / H@2e-3..8e-3 17/15/7/4d -- H wins big; but
    # eval_seq3 E 22d / H 62-67d and eval_seq4 E 86d / H 64/6/68/59d --
    # H unstable, the two-plane scene makes its decomposition flip
    # planes). The mechanism stays wired (host loop + device scan,
    # decision-parity tested) for scene families where it measures well.
    bootstrap_model_select: bool = False
    # motion-continuity guard: a keyframe-relative rotation exceeding this
    # angle is physically impossible between nearby frames and marks the
    # solve LOST instead of flipping the trajectory (a near-180 degree
    # mirror solution with high inlier support was measured on
    # self-similar texture: eval_seq3 frame 45, rot_err 10 -> 175 deg).
    # 0 disables.
    max_rel_rotation_deg: float = 60.0
    # guided frame-to-frame matching (models/visual_odometry.py): match
    # through a proximity gate on the normalised plane (matching.
    # match_gated with the previous frame's point as each feature's
    # predicted position -- inter-frame motion is small at tracking
    # frame rates). Beyond the search-space cut this fixes the ratio
    # test's statistics on repetitive texture, exactly like the map
    # gate. 0 disables; measured verdict in tools/ab_vo_guided.py.
    guided_radius: float = 0.0
    # two-view pose refinement: after RANSAC, triangulate the inlier
    # correspondences at the unit-baseline relative pose and refine the
    # relative pose by motion-only BA against them (backend/pnp.py) --
    # squeezes the last reprojection error out of the 8-point solution.
    # Measured verdict in tools/ab_vo_guided.py.
    refine_two_view: bool = False
    # triangulated-depth scale propagation (models/visual_odometry.py):
    # scale each VO step by the median depth ratio of features shared
    # across three consecutive frames, instead of the unit-norm |t|=1
    # convention. Off by default: A/B'd on the committed sequences
    # (tools/ab_vo_scale.py).
    scale_propagation: bool = False
    min_scale_matches: int = 10
    # step-magnitude prior for map-PnP dropout frames (models/slam.py):
    # when local-map PnP fails (too few inliers) the keyframe-relative
    # essential pose places the frame at |t_rel| = 1 MAP UNIT from the
    # keyframe -- a phantom step several times the true motion (measured
    # on eval_seq2: 21/56 frames fell back; an ORACLE magnitude cut the
    # online ATE 0.59 -> 0.35, so the magnitude IS the error term). With
    # this on, RANSAC's direction is kept but the keyframe displacement
    # is rescaled to recent keyframe-interval speed x frames elapsed
    # (keyframe_step_prior -- derivable from SlamState alone, so the
    # host loop and the device scan stay decision-identical). Default
    # OFF: no realisable predictor matched the oracle across sequences
    # (full A/B table in tools/ab_step_prior.py -- helps the held-out
    # eval_seq2 post-closure 0.478 -> 0.428 but regresses eval_seq3
    # 0.104 -> 0.160; prev-frame-relative, ungated-bootstrap and
    # cap-only variants all measured worse).
    step_magnitude_prior: bool = False
    # maturity gate for the prior: during bootstrap the keyframe spacing
    # IS the unit-norm convention (the map scale is still being defined
    # by those baselines), so rescaling bootstrap steps fights the map's
    # own scale; only fall back once this many keyframes exist.
    step_prior_min_kf: int = 4


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Windowed sparse bundle adjustment (Schur complement)."""

    window: int = 8  # camera poses per BA window
    max_points: int = 2048  # padded landmark capacity
    max_obs: int = 16384  # padded observation capacity
    gn_iters: int = 8  # Gauss-Newton/LM iterations (static, windowed BA)
    # LM iterations for GLOBAL BA (after loop closure): the post-graph
    # map starts far from the BA optimum (pose-graph correction + anchor
    # landmark transport leave large reprojection residuals) and the LM
    # damping schedule burns its first iterations on rejected steps while
    # lambda adapts -- measured on eval_seq2: 4 iterations moved nothing
    # (ATE 0.495 stuck), 20 -> 0.259, 36 -> 0.246 vs 0.352 pre-closure.
    global_iters: int = 32
    damping: float = 1e-4  # initial LM damping
    # Huber robust-kernel scale in normalised image coords (0 disables).
    # Without it one gross outlier association dominates the quadratic
    # objective and LM rejects every step: measured on eval_seq2
    # post-closure global BA, a |r|=25.8 row held total cost at 678.79
    # through 8 straight rejections (exact no-op) while the same problem
    # with huber=6e-3 converges. 6e-3 = map.pnp_inlier_threshold: beyond
    # the tracking inlier radius an observation is evidence of a bad
    # association, not geometry.
    huber: float = 6e-3
    # out-of-window FIXED observer cameras per windowed-BA problem
    # (ORB-SLAM's local-BA "fixed keyframes"): keyframes outside the
    # window that observe window landmarks contribute their reprojection
    # residuals with FROZEN poses, anchoring the window's scale and
    # orientation to the older map. Default 0 (the n_fixed=2 two-pinned-
    # camera scale anchor instead): measured on the committed sequences
    # the observer count is violently unstable -- pre-closure keyframe
    # ATE at fixed_observers 0/2/4/8: eval_seq3 0.130/0.418/0.085/0.093,
    # eval_seq4 0.339/0.770/0.412/0.779 -- frozen observer error feeds
    # forward window-over-window (eval_seq4 step-length ratios contracted
    # to 0.1-0.2x under fo=8, tools/diag_tracking.py), so a wrong anchor
    # compounds instead of averaging out. The n_fixed=2 fallback is
    # stable across all four sequences (0.102/0.352/0.130/0.339).
    fixed_observers: int = 0
    # select the BA window by covisibility (newest keyframe + its most
    # covisible partners, the ORB-SLAM local-BA neighbourhood) instead of
    # the last `window` keyframes temporally. Helps after loop closures /
    # revisits where the best constraints are not the temporal neighbours.
    covisibility_window: bool = False


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Device-side SLAM map (backend/keyframes.py pytree stores).

    The reference has no map at all (frontend-only, README.md:22); these
    capacities bound the fixed-shape keyframe/landmark/observation arrays.
    ``keyframe_capacity`` keyframes are kept in a ring (oldest evicted);
    landmarks/observations past capacity are dropped newest-first."""

    keyframe_capacity: int = 64
    max_landmarks: int = 8192
    max_obs: int = 16384
    # motion-only BA of each frame against matched map landmarks
    # (ORB-SLAM-style local-map tracking; resolves monocular scale drift)
    track_map: bool = True
    map_match_max_distance: int = 48
    min_map_inliers: int = 25
    pnp_iters: int = 8
    pnp_inlier_threshold: float = 6e-3
    # projection gate for map matching (normalised-plane radius; 0 = off):
    # landmarks are projected with the pose prior and each feature matches
    # only within this radius (matching.match_gated). Resolves descriptor
    # aliasing -- without the gate, a far-away landmark with a similar
    # descriptor makes the Lowe ratio test kill the correct match.
    gate_radius: float = 0.0
    # refresh a landmark's anchor descriptor to the newest observation at
    # keyframe insertion (cheap stand-in for ORB-SLAM's most-representative
    # selection). Measured on the committed sequences (post-closure
    # keyframe ATE): eval_seq 0.045 -> 0.058, eval_seq2 0.155 -> 0.193 --
    # association churn outweighs the viewpoint adaptation at these
    # trajectory lengths, so the default stays OFF; revisit for long
    # sessions with large viewpoint drift.
    refresh_descriptors: bool = False
    # insert a keyframe when local-map PnP drops below min_map_inliers
    # while frame-to-frame tracking still holds (the ORB-SLAM "tracking
    # weak -> insert" criterion): triangulates fresh landmarks exactly
    # where map coverage thinned, so subsequent frames PnP again instead
    # of chaining unit-norm fallback steps (the eval_seq2 failure mode,
    # tools/ab_step_prior.py). Measured (post-closure keyframe ATE): a
    # strict Pareto win -- held-out eval_seq2 0.478 -> 0.426 (online
    # 0.59 -> 0.43), eval_seq and eval_seq3 bit-identical (their dropout
    # frames already insert via the inlier/gap rules) -- hence default ON
    # unlike the pose-rescaling alternatives, which traded one sequence
    # against another.
    keyframe_on_map_dropout: bool = True
    # chunk-boundary re-triangulation (models/slam.py:process_chunk):
    # landmarks created inside a multi-frame chunk are re-triangulated
    # from their first two observations using the boundary-BA-refined
    # poses, then BA runs once more. Built for the round-4 chunk accuracy
    # gap (chunk-8 eval_seq4 online ATE 0.78 vs 0.44 -- in-chunk inserts
    # triangulated against unrefined poses), but the HUBER windowed BA
    # closed that gap by itself and re-triangulation now measurably
    # HURTS: tools/ab_chunk_accuracy.py (2026-08-20) eval_seq4 chunk-8
    # off 0.398 / on 0.439, chunk-4 off 0.386 / on 0.466 (host loop
    # 0.358) -- resetting robust-BA-refined landmarks to raw two-view
    # geometry discards refinement. Default OFF; chunk size 1 never
    # re-triangulates either way (parity with process()).
    chunk_retriangulate: bool = False
    # neighbourhood loop closure (models/slam.py:try_close_loop): the loop
    # pose is PnP-measured against the UNION of landmarks observed by the
    # matched keyframe and its most covisible neighbours, and one weighted
    # pose-graph edge is emitted per old keyframe whose own landmarks give
    # >= loop_edge_min_support PnP inliers (the ORB-SLAM loop-correction
    # neighbourhood, re-expressed with the covisibility matmul). A single
    # keyframe's landmark set was the round-4 edge and its measured error
    # (0.24 m translation on eval_seq2) was the same order as the drift it
    # corrected -- the neighbourhood union is what buys edge accuracy.
    loop_neighbours: int = 5            # max covisible neighbours unioned
    loop_neighbour_min_covis: int = 10  # min shared landmarks to join
    loop_edge_min_support: int = 12     # min PnP inliers to emit an edge
    # after a successful loop PnP, append observation rows linking the
    # current keyframe to the PnP-inlier OLD landmarks (ORB-SLAM's loop
    # fusion): global BA then enforces the closure on the map geometry
    # itself instead of relying on pose-graph edges alone.
    loop_fuse_observations: bool = True
    # optimise the loop-closure pose graph over Sim(3) instead of SE(3):
    # each keyframe carries a scale DOF so monocular scale drift is
    # absorbed as scale change along the chain instead of being forced
    # into rotations/translations (the ORB-SLAM essential-graph
    # formulation; backend/pose_graph.py optimize(sim3=True)). Measured
    # on the committed sequences (post-closure keyframe ATE, SE3 vs
    # Sim3): eval_seq 0.0866/0.0860, eval_seq2 0.4776/0.4803, eval_seq3
    # 0.1039/0.1617 -- map-PnP tracking already pins the scale here, so
    # the extra DOF only loosens the graph (and the scale-consistent
    # landmark transport moves points global BA then fails to pull
    # back on seq3). Default stays OFF; the mode exists for VO-only
    # pipelines where scale genuinely drifts (unit-tested against
    # synthetic scale drift in tests/test_backend.py).
    pose_graph_sim3: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for multi-chip scaling (data axis = frames, model axis =
    map shards). The reference has no distributed layer (SURVEY.md section 2);
    this is specified by the north star in BASELINE.json."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class PislamConfig:
    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    vo: VOConfig = dataclasses.field(default_factory=VOConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "PislamConfig":
        d = json.loads(s)
        return PislamConfig(
            pyramid=PyramidConfig(**d.get("pyramid", {})),
            frontend=FrontendConfig(**d.get("frontend", {})),
            matcher=MatcherConfig(**d.get("matcher", {})),
            vo=VOConfig(**d.get("vo", {})),
            ba=BAConfig(**d.get("ba", {})),
            map=MapConfig(**d.get("map", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
        )
