"""Frozen-dataclass config tree (SURVEY.md §2b N21).

The reference used hard-coded constants + argv (SURVEY.md §5 "Config/flag
system"; mount empty, §0). Here: one immutable `SlamConfig` tree, JSON file
round-trip, dotted CLI overrides ("--icp.max_iters=30"), and a stable hash
recorded in metrics and checkpoints.

All configs are hashable (frozen) so they can be jit static arguments.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from typing import Any


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    method: str = "point_to_point"  # point_to_point | point_to_plane | projective
    max_iters: int = 30
    unroll_iters: int = 0  # >0: replace the while_loop with that many
    # trace-time-unrolled iterations (convergence via state freezing).
    # Straight-line code has no per-iteration loop control on the device
    # but costs unroll_iters of kernel work unconditionally, so pick ~1.5x
    # the typical converged iteration count. Its cost on the GPU is not
    # measured yet.
    tol: float = 1e-6  # convergence: |rmse_prev - rmse| < tol
    tol_update: float = 0.0  # >0: also converge when the step's translation
    # magnitude drops below this (meters) — direct and noise-immune
    max_corr_dist: float = 1e9  # correspondence distance gate (meters)
    corr_range_rate: float = 0.0  # >0: widen the gate per point with its
    # RANGE: gate_p = max_corr_dist + rate × ‖p‖ — an angular allowance.
    # A fixed metric gate caps the trackable per-frame rotation at
    # ~gate/range rad (1.0 m @ 10 m ≈ 6°); the r4 lap's sharpest corner
    # turns 15°/frame, so rotation became invisible to ICP (points moved
    # ~2.6 m tangentially, outside the gate) while rmse stayed low — the
    # heading lagged 60° and frontier inserts baked it into the map.
    # rate 0.1 ≈ allow 6°+atan(0.1) of untracked rotation at any range
    # while the NEAR field stays tight (the corner-mouth boundary-latch
    # drag that motivated the 1.0 m gate lives at close range).
    normal_gate_cos: float = -1.0  # reject pairs with normal dot < this
    damping: float = 1e-6  # Levenberg damping for the 6x6 GN solve
    degen_eps: float = 0.0  # >0: degeneracy-aware solution remapping — zero
    # the GN update along eigendirections of H with eigenvalue below
    # degen_eps x the largest (the pose keeps its motion-model prediction
    # there). Expert opt-in, DEFAULT OFF: measured on the multisession
    # corridor routes it made things WORSE (froze translation entirely —
    # see point_to_plane.solve_increment docstring). point_to_plane only.
    prior_trans_weight: float = 0.0  # >0: motion-model prior — a Tikhonov
    # term anchoring the solve at the ICP's init pose (= the motion-model
    # prediction in scan_to_map). The value is a FRACTION of the frame's
    # summed correspondence weight: λ = fraction × Σw, so the prior's
    # strength is scale-invariant (an absolute λ that is negligible at 10k
    # inliers freezes the pose at 1k — measured r3). Negligible in observed
    # directions, dominant exactly where H is degenerate (corridor travel
    # axis) — the well-behaved alternative to degen_eps remapping.
    # point_to_plane only. Typical: 0.01.
    prior_rot_weight: float = 0.0  # same, rotation block. Typical: 0.1
    # (rotation H entries scale with |p×n|² ~ range², so equal suppression
    # needs a larger fraction)
    step_scale: float = 1.0  # >1: over-relax each ICP update (Besl-McKay-style
    # extrapolation; plain ICP undershoots because correspondences lag)
    anderson: bool = False  # AA(1) acceleration of the fixed-point iteration
    # (safeguarded; see AA-ICP, PAPERS.md)
    max_step_trans: float = 0.0  # >0: clamp per-iteration GN translation (m)
    max_step_rot: float = 0.0  # >0: clamp per-iteration GN rotation (rad)
    max_total_trans: float = 0.0  # >0: TRUST REGION on the total correction —
    # clamp ‖log(T·T0⁻¹)‖ translation to this every iteration, so the solve
    # refines within a ball around the motion-model prediction instead of
    # walking off through self-similar structure (r4 lap trace: per-iteration
    # clamps alone let 18 iterations slide the pose 4–9 m into an aliased
    # basin at a corner approach, and the misplaced frame then poisoned the
    # map). In odometry the correction magnitude is bounded by the
    # prediction error scale (~1 frame of motion); large corrections are the
    # relocalizer/backend's job, not the front-end's. Scan-to-map pipelines
    # should set this ~1.5× the per-frame motion. Leave 0 for generic
    # alignment (cli align, loop-closure verify) where big offsets are real.
    max_total_rot: float = 0.0  # same, rotation part (rad)
    min_inliers: int = 0  # below this, the iteration keeps T unchanged
    nn_backend: str = "auto"  # auto | pallas | xla | voxel; "auto" is
    # the Pallas kernel on a GPU and XLA on the CPU (kernels/nn.py)
    nn_chunk: int = 2048  # src rows per chunk of the XLA NN version
    voxel_table_size: int = 16384  # hash-grid slots (power of two), voxel backend
    voxel_bucket: int = 16  # max points per hash bucket, voxel backend
    huber_delta: float = 0.0  # 0 = plain least squares


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    # 2D occupancy grid
    grid_size: int = 512  # cells per side
    grid_resolution: float = 0.05  # meters per cell
    logodds_hit: float = 0.9
    logodds_free: float = -0.4
    logodds_clip: float = 10.0
    ray_samples: int = 128  # free-space samples per beam
    # 3D voxel keyframe map
    map_capacity: int = 65536  # max points in the global map
    local_model_size: int = 16384  # points extracted for scan-to-map ICP
    map_voxel: float = 0.4  # dedup voxel size (meters)
    insert_backend: str = "sort"  # sort | hash: voxel-dedup insert via the
    # full lexsort (exact eviction order) or the sort-free hash-probe path
    # (voxel_map.insert_hash — map slots stay put, lazy eviction; built to
    # remove the per-keyframe lexsort, r3 SOL decomposition)
    extract_approx: bool = False  # local-model selection via approx_min_k
    # instead of exact top_k — see voxel_map.extract_local
    extract_hysteresis: float = 0.0  # >0: reuse the carried local model
    # until the predicted sensor moved this far from the extraction center
    # (or a keyframe changed the map) instead of re-extracting every frame.
    # The coverage gate shrinks by the staleness offset, so correctness is
    # preserved. Default off; its speed on the GPU is not measured yet.


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    mode: str = "scan_to_scan"  # scan_to_scan | scan_to_map
    scan_capacity: int = 4096  # padded size of each input scan
    keyframe_trans: float = 1.0  # new keyframe after this much translation
    keyframe_rot: float = 0.3  # ... or this much rotation (rad)
    keyframe_min_inlier_frac: float = 0.3  # insert only if ICP is this healthy
    keyframe_max_rmse: float = 0.6  # ... or rmse below this even if not converged
    frontier_insert: bool = True  # ALSO insert (healthy frames only) when the
    # map frontier is under pressure: in-coverage fraction below
    # frontier_cov_frac, or mid-turn (rotation since last keyframe beyond
    # half keyframe_rot). Keyframe-cadence inserts alone freeze the frontier
    # exactly at 90° corners — the scan faces unmapped corridor, inliers
    # collapse, and ICP re-localizes backward into the self-similar mapped
    # stretch (r3 endurance trace: ATE 28.7 m from one corner). Pressure
    # inserts keep the frontier at most one frame behind through turns,
    # KISS-ICP-style, while straight legs (coverage ~0.7) never trigger.
    frontier_cov_frac: float = 0.6  # in-coverage fraction threshold
    normal_k: int = 8  # k-NN plane-fit neighborhood for map normals
    normal_approx: bool = True  # k-NN via lax.approx_min_k vs exact
    # top_k. On the CPU and the GPU approx_min_k is exact, so this knob
    # changes nothing there; pair with normal_oversample.
    normal_oversample: int = 8  # >1 with normal_approx: fetch
    # k × oversample approximate candidates, then select the exact top-k
    # among them (values are exact f32; only the SELECTION is approximate,
    # so an oversampled shortlist + exact rescore drives the effective
    # recall toward 1).
    normal_ref_stride: int = 1  # >1: fit planes against every Nth point
    # (shrinks the keyframe normals distance matrix by the stride; see
    # mapping.normals.normals_knn)
    motion_model: str = "constant_velocity"  # constant_velocity | identity
    donate_state: bool = False  # donate the state pytree to the jitted step
    # (in-place map/grid update, no copy; incompatible with the runner's
    # revert-on-fault path, so off by default)
    motion_damping: float = 0.5  # scale on the constant-velocity twist (0=identity);
    # full CV (1.0) is unstable in the scan-to-map feedback loop (see
    # slam/scan_to_map._step) — 0.25–0.5 measured best on the synthetic logs
    motion_damping_rot: float = -1.0  # separate damping for the ROTATION
    # part of the predicted twist (-1 = use motion_damping). The r2
    # instability argument is translational (position-error feedback
    # through the map); under-predicting rotation is what starves sharp
    # corners — the solve must then recover the full turn rate through a
    # range-limited correspondence gate. 0.85-0.9 keeps the rotation
    # prediction within a few degrees of a steady turn.
    downsample_voxel: float = 0.0  # 0 = off (host-side preprocessing)
    rgbd_src_stride: int = 1  # >1: decimate the SOURCE pixel grid of the
    # projective ICP by this stride (KinectFusion-style coarse level).
    # Target vertex/normal maps stay full-resolution, so correspondence
    # lookup precision is unchanged; at 640x480 stride 2 keeps 76.8k source
    # points (>=64k organized-cloud bound, VERDICT r2 item 6) and cuts the
    # GN accumulation 4x


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    enabled: bool = False
    descriptor_rings: int = 20
    descriptor_sectors: int = 60
    candidate_topk: int = 4
    min_loop_separation: int = 20  # keyframes
    gating_radius: float = 20.0  # m; candidate gate on odometry-estimate distance
    verify_max_dev: float = 5.0  # m; measured loop vs odometry-predicted relpose
    verify_drift_rate: float = 0.0  # >0: widen the dev gate with the odometry
    # PATH LENGTH between the two keyframes: allowed = max(verify_max_dev,
    # rate × path_m). The deviation of a TRUE closure equals the accumulated
    # drift, which grows with distance travelled (1-8% measured) — a fixed
    # 4-5 m gate structurally rejects every true lap closure once drift
    # exceeds it (r4 endurance run: 157 candidates, 0 accepted). Typical
    # 0.08; alias rejection then rests on rmse + PCM + residual gates.
    verify_max_rmse: float = 0.5
    pg_iters: int = 10
    pg_damping: float = 1e-6
    huber_delta: float = 1.0
    pcm_gamma: float = 0.5  # >0: pairwise-consistency maximization over
    # accepted closures (largest mutually-consistent clique; Mangelson-style
    # PCM, backend/pose_graph.pairwise_consistent_closures) — the principal
    # back-end defense against perceptual-alias closures, robust to global
    # drift because consistency cycles use only local odometry
    reject_residual: float = 0.75  # >0: additionally drop loop factors
    # whose residual at the first optimum exceeds this (twist norm), then
    # re-optimize (backend/pose_graph.reject_inconsistent_loops)
    max_keyframes: int = 512
    max_factors: int = 2048
    odom_strain_penalty: float = 3.0  # >0: down-weight each odometry factor
    # by 1/(1 + penalty × n_strained) where n_strained counts frames in the
    # factor's span that hit the ICP iteration cap without converging. The
    # pose graph otherwise treats every odometry factor as equally reliable
    # and smears a loop-closure discrepancy uniformly around the cycle —
    # bending segments the front-end tracked perfectly (r4 lap: a 60°
    # heading loss in one degenerate corner became a 38.7 m mid-lap bow;
    # strain weighting localizes part of the correction: 30.6 m at 3.0,
    # 24.8 at 10.0 — BASELINE.md r4). Residual-blind frames (degenerate
    # geometry that converges happily) still escape this signal; closure
    # DENSITY (multi-lap revisits) is the structural fix.
    strain_on_clamp: bool = False  # also count frames whose ICP correction
    # sits ON the total-correction trust-region ball (infos["clamped"]) as
    # strained. Forensic basis (endurance3b, BASELINE.md r5b): the lap-4
    # walk-off accrued EXACTLY the ball radius per frame for ~43 straight
    # frames while iteration-strain stayed silent (ICP "converged" at the
    # boundary) — a pegged trust region is the solver saying it wanted to
    # go further. Opt-in so recorded runs reproduce; flip after a lap A/B.
    suspect_cycle: float = 1.0  # metres-equivalent PCM cycle score above
    # which an ACCEPTED closure is flagged suspect in reports/saved maps —
    # aliases the whole graph agrees on can't be rejected (DESIGN.md §13)
    # but must be visible to map consumers (VERDICT r2 item 9)
    verify_stride: int = 1  # >1: decimate BOTH scans by this stride for
    # loop verification ICP. Verification only needs a rigid transform at
    # ~dm accuracy (the pose graph's measurement noise is the drift being
    # closed, metres); a 4k-point alignment recovers transforms to <1e-3
    # (config 1), so running the verify ICP at 16k scan capacity pays 16x
    # the NN cost for nothing.
    verify_yaws: int = 8  # yaw hypotheses per candidate: top-ceil(Y/2)
    # descriptor shifts + (Y - that) cardinal yaws. 8 was the r2 default;
    # 4 (top-2 shifts + 2 cardinals) halves the verification batch.
    closure_dedup_kf: int = 0  # >0: skip verifying a candidate when an
    # ACCEPTED closure already links the same revisit region — query within
    # this many keyframes of an accepted query AND match within this many
    # of its match. At multi-lap candidate density every keyframe of a
    # revisited stretch re-verifies the same place (r4 endurance2: 178
    # accepted closures where ~a dozen distinct regions exist); the pose
    # graph gains nothing from the 15th closure of the same seam, and each
    # skip saves a full verification dispatch.
    verify_chunk: int = 4  # candidates verified per device dispatch: the
    # (candidates x 8 yaw hypotheses) nested-vmap ICP grows transient NN
    # buffers ~linearly in C, which OOMs at 16k-point scan capacity if all
    # topk candidates launch at once (ADVICE r2); 0 = unchunked


@dataclasses.dataclass(frozen=True)
class DistConfig:
    mesh_axes: tuple = ("hosts",)
    mesh_shape: tuple = (1,)
    shard_points: bool = False  # shard the NN source axis across devices


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    warmup: int = 3
    frames: int = 50
    repeats: int = 3


@dataclasses.dataclass(frozen=True)
class DebugConfig:
    nans: bool = False  # jax_debug_nans: trap NaN at the op that produced it
    log_compiles: bool = False  # jax_log_compiles: surface silent retraces


def apply_debug(cfg: "DebugConfig") -> None:
    """Wire the debug toggles into the jax runtime (SURVEY.md §5 sanitizers
    row — the functional-JAX stand-in for cuda-memcheck-style tooling)."""
    import jax

    jax.config.update("jax_debug_nans", bool(cfg.nans))
    jax.config.update("jax_log_compiles", bool(cfg.log_compiles))


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    dist: DistConfig = dataclasses.field(default_factory=DistConfig)
    bench: BenchConfig = dataclasses.field(default_factory=BenchConfig)
    debug: DebugConfig = dataclasses.field(default_factory=DebugConfig)


def _to_dict(cfg) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def _from_dict(cls, d: dict):
    # field annotations are strings under `from __future__ import annotations`
    # — resolve them to real types before recursing
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _from_dict(ftype, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def to_json(cfg: SlamConfig) -> str:
    return json.dumps(_to_dict(cfg), indent=2, sort_keys=True)


def from_json(s: str) -> SlamConfig:
    return _from_dict(SlamConfig, json.loads(s))


def config_hash(cfg: SlamConfig) -> str:
    return hashlib.sha256(to_json(cfg).encode()).hexdigest()[:12]


def override(cfg: SlamConfig, dotted: dict[str, Any]) -> SlamConfig:
    """Apply {"icp.max_iters": 50, ...} dotted overrides immutably."""
    d = _to_dict(cfg)
    for key, value in dotted.items():
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise KeyError(f"unknown config key: {key}")
        old = node[leaf]
        if old is not None and not isinstance(old, type(value)):
            # coerce strings from CLI
            if isinstance(old, bool):
                value = str(value).lower() in ("1", "true", "yes")
            elif isinstance(old, int):
                value = int(value)
            elif isinstance(old, float):
                value = float(value)
            elif isinstance(old, (list, tuple)):
                value = tuple(
                    json.loads(value) if isinstance(value, str) else value
                )
        node[leaf] = value
    return _from_dict(SlamConfig, d)
