"""Loop-closure detection (SURVEY.md §2b N13; BASELINE.json config 4).

Scan-context-style descriptors: each keyframe scan becomes a (rings × sectors)
polar image whose cells hold the max point height in that (range, azimuth)
bin — rotation about z shifts the sector axis, so matching scans under yaw
becomes a max over circular shifts of a cosine similarity. On the device the
whole candidate search is one einsum: (K, R·S) keyframe descriptors × (S, R·S)
shifted queries → (K, S) scores, max over shifts — no tree, no loop.

Candidates are gated by keyframe separation, then verified geometrically by
full ICP (icp/loop.py) with the descriptor's best-shift yaw as the initial
rotation; accepted closures become pose-graph factors (backend/pose_graph.py).
The reference has no backend at all (SURVEY.md §2a) — this is the
driver-mandated extension.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_icp_slam.config import BackendConfig, ICPConfig
from tpu_icp_slam.core import se3
from tpu_icp_slam.core.pointcloud import PointCloud
from tpu_icp_slam.icp.loop import align


@partial(jax.jit, static_argnames=("rings", "sectors"))
def scan_context(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    rings: int = 20,
    sectors: int = 60,
    max_range: float = 60.0,
) -> jnp.ndarray:
    """Sensor-frame scan -> (rings, sectors) polar descriptor.

    3D scans (N, 3): max point height per (range, azimuth) bin (classic scan
    context). 2D scans (N, 2): occupancy count per bin (the grid
    cross-correlation analogue, SURVEY.md §2b N13) — there is no height axis.
    """
    x, y = points[:, 0], points[:, 1]
    r = jnp.sqrt(x * x + y * y)
    ring = jnp.clip((r / max_range * rings).astype(jnp.int32), 0, rings - 1)
    theta = jnp.arctan2(y, x)  # [-pi, pi)
    sector = jnp.clip(
        ((theta + jnp.pi) / (2 * jnp.pi) * sectors).astype(jnp.int32), 0, sectors - 1
    )
    flat = ring * sectors + sector
    if points.shape[1] >= 3:
        # max-height per bin; invalid points write -inf (then floored to 0)
        zval = jnp.where(mask, points[:, 2], -jnp.inf)
        desc = jnp.full((rings * sectors,), -jnp.inf, points.dtype)
        desc = desc.at[flat].max(zval)
        desc = jnp.where(jnp.isfinite(desc), desc, 0.0)
    else:
        ones = jnp.where(mask, 1.0, 0.0).astype(points.dtype)
        desc = jnp.zeros((rings * sectors,), points.dtype).at[flat].add(ones)
    return desc.reshape(rings, sectors)


@jax.jit
def shift_score_matrix(query: jnp.ndarray, descs: jnp.ndarray) -> jnp.ndarray:
    """(K, S) column-cosine score of `query` (R, S) vs descs (K, R, S) at
    every circular sector shift."""
    s = query.shape[-1]
    shifts = jnp.arange(s)
    shifted = jax.vmap(lambda k: jnp.roll(query, k, axis=-1))(shifts)  # (S, R, S)
    qcol = jnp.linalg.norm(shifted, axis=-2)  # (S, S) column norms
    dcol = jnp.linalg.norm(descs, axis=-2)  # (K, S)
    dots = jnp.einsum("krs,mrs->kms", descs, shifted)
    denom = dcol[:, None, :] * qcol[None, :, :]
    both = denom > 1e-9
    cos = jnp.where(both, dots / jnp.maximum(denom, 1e-9), 0.0)
    n_both = jnp.maximum(jnp.sum(both, axis=-1), 1)
    return jnp.sum(cos, axis=-1) / n_both  # (K, S)


@partial(jax.jit, static_argnames=("topk",))
def _gated_candidate_scores(
    query: jnp.ndarray,  # (R, S)
    descs: jnp.ndarray,  # (cap, R, S) device keyframe store (masked by lo)
    positions: jnp.ndarray,  # (cap, 3); NaN rows = unknown position
    qpos: jnp.ndarray,  # (3,); NaN = no odometry estimate
    lo: jnp.ndarray,  # () int32: only keyframes [0, lo) are eligible
    gating_radius: jnp.ndarray,  # () f32; inf disables the gate
    topk: int,
):
    """One-dispatch candidate search over the whole keyframe store.

    Runs the shift-invariant scoring against the full fixed-capacity buffer
    (static shapes — no per-keyframe recompiles), applies the age and
    odometry-position gates on device, and returns the top-k
    (scores, shifts, indices) — only 3·topk scalars cross to the host.
    NaN positions (unknown) pass the gate, matching the host semantics:
    gating needs BOTH positions known.
    """
    scores, shifts = shift_match_scores(query, descs)  # (cap,), (cap,)
    cap = descs.shape[0]
    valid = jnp.arange(cap) < lo
    dist = jnp.linalg.norm(positions - qpos[None, :], axis=-1)
    gate = jnp.where(jnp.isnan(dist), True, dist <= gating_radius)
    scores = jnp.where(valid & gate, scores, -jnp.inf)
    top_s, top_i = jax.lax.top_k(scores, topk)
    return top_s, shifts[top_i], top_i


@jax.jit
def shift_match_scores(query: jnp.ndarray, descs: jnp.ndarray):
    """Yaw-invariant similarity of `query` (R, S) against descs (K, R, S).

    Scan-context column scoring: at each circular shift, the score is the
    mean cosine between per-sector *columns* (ring profiles), averaged over
    sectors where both columns are non-empty — much more discriminative than
    a whole-image cosine when bins are sparse. Returns (scores (K,),
    best_shift (K,)); shift s means the candidate is rotated by s·2π/S
    relative to the query.
    """
    scores = shift_score_matrix(query, descs)  # (K, S)
    best_shift = jnp.argmax(scores, axis=-1)
    return jnp.max(scores, axis=-1), best_shift.astype(jnp.int32)


@partial(
    jax.jit,
    static_argnames=("cfg_coarse", "cfg_fine", "sectors", "dim", "n_yaws"),
)
def _batched_verify(
    query_points: jnp.ndarray,  # (M, D)
    query_mask: jnp.ndarray,  # (M,)
    match_points: jnp.ndarray,  # (C, N, D)
    match_mask: jnp.ndarray,  # (C, N)
    query_desc: jnp.ndarray,  # (R, S)
    match_descs: jnp.ndarray,  # (C, R, S)
    *,
    cfg_coarse: ICPConfig,
    cfg_fine: ICPConfig,
    sectors: int,
    dim: int,
    n_yaws: int = 8,
):
    """(candidates × yaw-hypotheses) coarse-to-fine verification, one program.

    Yaw hypotheses per candidate: the top-ceil(Y/2) descriptor shifts
    (computed on device from one shift_score_matrix call) + (Y − that)
    cardinal yaws — sparse descriptors give an unreliable single shift, so
    ICP seeds from a basket and the best-rmse lock wins. Returns an
    ICPResult pytree with leading (C, Y).
    """
    n_desc = (n_yaws + 1) // 2
    n_card = n_yaws - n_desc
    rows = shift_score_matrix(query_desc, match_descs)  # (C, S)
    _, topd = jax.lax.top_k(rows, n_desc)  # (C, n_desc)
    yaw_d = topd.astype(jnp.float32) * (2 * jnp.pi / sectors)
    cardinals = jnp.asarray(
        [0.0, jnp.pi, jnp.pi / 2, -jnp.pi / 2], jnp.float32
    )[:n_card]
    yaws = jnp.concatenate(
        [yaw_d, jnp.broadcast_to(cardinals, (rows.shape[0], n_card))], axis=1
    )  # (C, Y)

    def rotz(y):
        c, s = jnp.cos(y), jnp.sin(y)
        T = jnp.eye(dim + 1, dtype=jnp.float32)
        return T.at[:2, :2].set(jnp.asarray([[c, -s], [s, c]]))

    inits = jax.vmap(jax.vmap(rotz))(yaws)  # (C, 8, d+1, d+1)
    src = PointCloud(points=query_points, mask=query_mask)

    def one_candidate(dst_pts, dst_msk, T0s):
        dst = PointCloud(points=dst_pts, mask=dst_msk)
        coarse = jax.vmap(lambda t: align(src, dst, t, cfg_coarse))(T0s)
        return jax.vmap(lambda t: align(src, dst, t, cfg_fine))(coarse.T)

    return jax.vmap(one_candidate)(match_points, match_mask, inits)


@dataclasses.dataclass
class LoopCandidate:
    query_idx: int
    match_idx: int
    score: float
    yaw: float  # descriptor-estimated relative yaw (radians)


@dataclasses.dataclass
class LoopClosure:
    i: int  # earlier keyframe
    j: int  # later keyframe
    T_ij: np.ndarray  # (4, 4) measured X_i⁻¹ X_j
    rmse: float
    n_inliers: int


class LoopDetector:
    """Keyframe descriptor store + candidate search + ICP verification.

    Host-orchestrated (runs once per keyframe, not per frame); all heavy math
    (descriptors, score matrix, verification ICP) is jitted on device.
    """

    def __init__(self, cfg: BackendConfig, icp_cfg: Optional[ICPConfig] = None,
                 max_range: float = 60.0):
        self.cfg = cfg
        # coarse-to-fine: descriptors give yaw but no translation, and loop
        # revisits can be metres off laterally — a single tight gate has too
        # small a basin. Stage 1 locks on with a wide gate, stage 2 refines.
        self.icp_coarse = icp_cfg or ICPConfig(
            method="point_to_point",
            max_iters=50,
            max_corr_dist=6.0,
            nn_backend="auto",
            huber_delta=1.5,
            max_step_trans=3.0,
            max_step_rot=0.5,
            min_inliers=30,
            tol=1e-5,
        )
        self.icp_fine = dataclasses.replace(
            self.icp_coarse, max_corr_dist=1.5, huber_delta=0.5, max_iters=30
        )
        self.max_range = max_range
        # host-side copies (serialization source for checkpoints) ...
        self._descs: list[np.ndarray] = []
        self._positions: list = []
        # ... plus the device-resident keyframe store the hot path reads:
        # descriptors and positions stay on device between keyframes, so a
        # candidate search moves only top-k scalars over PCIe (VERDICT r1
        # item 6 — host round-trips were the backend scaling cliff)
        self._descs_dev: Optional[jnp.ndarray] = None  # (cap, R, S)
        self._pos_dev: Optional[jnp.ndarray] = None  # (cap, 3)
        self._n_dev: int = 0  # keyframes reflected in the device store

    # -- device keyframe store ------------------------------------------------

    def _ensure_capacity(self, n: int) -> None:
        r, s = self.cfg.descriptor_rings, self.cfg.descriptor_sectors
        if self._descs_dev is None:
            cap = max(64, getattr(self.cfg, "max_keyframes", 512))
            self._descs_dev = jnp.zeros((cap, r, s), jnp.float32)
            self._pos_dev = jnp.full((cap, 3), jnp.nan, jnp.float32)
        while self._descs_dev.shape[0] < n:  # double on overflow
            self._descs_dev = jnp.concatenate(
                [self._descs_dev, jnp.zeros_like(self._descs_dev)]
            )
            self._pos_dev = jnp.concatenate(
                [self._pos_dev, jnp.full_like(self._pos_dev, jnp.nan)]
            )

    def _sync_device_store(self) -> None:
        """Rebuild the device store from the host lists (checkpoint resume
        writes the host lists directly)."""
        self._descs_dev = None
        self._ensure_capacity(len(self._descs) + 1)
        if self._descs:
            descs = jnp.asarray(np.stack(self._descs), jnp.float32)
            self._descs_dev = self._descs_dev.at[: len(self._descs)].set(descs)
            pos = np.full((len(self._positions), 3), np.nan, np.float32)
            for i, p in enumerate(self._positions):
                if p is not None:  # pad 2D positions with z=0 (xy gating)
                    pos[i, : len(p)] = np.asarray(p, np.float32)
                    pos[i, len(p):] = 0.0
            self._pos_dev = self._pos_dev.at[: len(pos)].set(jnp.asarray(pos))
        self._n_dev = len(self._descs)

    def add_keyframe(self, points, mask, position=None) -> int:
        d = scan_context(
            jnp.asarray(points, jnp.float32),
            jnp.asarray(mask),
            rings=self.cfg.descriptor_rings,
            sectors=self.cfg.descriptor_sectors,
            max_range=self.max_range,
        )
        idx = len(self._descs)
        if self._descs_dev is None or self._n_dev != idx:
            self._sync_device_store()  # host lists were mutated externally
        self._ensure_capacity(idx + 1)
        self._descs_dev = self._descs_dev.at[idx].set(d)
        self._n_dev = idx + 1
        if position is not None:
            p3 = np.full((3,), np.nan, np.float32)
            p3[: len(position)] = np.asarray(position, np.float32)
            # pad unknown z with 0 so 2D positions gate on xy distance
            p3 = np.nan_to_num(p3, nan=0.0)
            self._pos_dev = self._pos_dev.at[idx].set(jnp.asarray(p3))
        self._descs.append(np.asarray(d))
        self._positions.append(
            None if position is None else np.asarray(position, np.float64)
        )
        return idx

    def candidates(self, query_idx: int) -> list[LoopCandidate]:
        """Descriptor matches against old-enough keyframes, gated by the
        odometry-estimate distance (cfg.gating_radius) when positions are
        known — the covariance gate that defeats perceptual aliasing in
        self-similar worlds (SURVEY.md §2b N13). One device dispatch over the
        fixed-capacity store; only the top-k triple lands on the host."""
        lo = query_idx - self.cfg.min_loop_separation
        if lo <= 0:
            return []
        if self._descs_dev is None or self._n_dev != len(self._descs):
            # store out of sync (e.g. detector state restored by hand);
            # `!=` not `<`: a restore can SHRINK the host lists too (ADVICE r2)
            self._sync_device_store()
        qpos_np = self._positions[query_idx]
        qpos = jnp.asarray(
            np.concatenate([
                np.asarray(qpos_np, np.float32),
                np.zeros(3 - len(qpos_np), np.float32),
            ])
            if qpos_np is not None
            else np.full(3, np.nan, np.float32)
        )
        radius = (
            jnp.float32(self.cfg.gating_radius)
            if self.cfg.gating_radius > 0
            else jnp.float32(jnp.inf)
        )
        top_s, top_shift, top_i = _gated_candidate_scores(
            self._descs_dev[query_idx],
            self._descs_dev,
            self._pos_dev,
            qpos,
            jnp.asarray(lo, jnp.int32),
            radius,
            topk=self.cfg.candidate_topk,
        )
        top_s = np.asarray(top_s, np.float64)
        top_shift = np.asarray(top_shift)
        top_i = np.asarray(top_i)
        out = []
        for k in range(len(top_i)):
            if not np.isfinite(top_s[k]):
                continue
            yaw = top_shift[k] * 2 * np.pi / self.cfg.descriptor_sectors
            if yaw > np.pi:
                yaw -= 2 * np.pi
            out.append(
                LoopCandidate(
                    query_idx=query_idx,
                    match_idx=int(top_i[k]),
                    score=float(top_s[k]),
                    yaw=float(yaw),
                )
            )
        return out

    def verify(
        self,
        cand: LoopCandidate,
        query_points,
        query_mask,
        match_points,
        match_mask,
        T_pred=None,
        query_desc=None,
    ) -> Optional[LoopClosure]:
        """Single-candidate wrapper over verify_batch (see there)."""
        out = self.verify_batch(
            [cand],
            query_points,
            query_mask,
            np.asarray(match_points)[None],
            np.asarray(match_mask)[None],
            T_preds=None if T_pred is None else np.asarray(T_pred)[None],
            query_desc=query_desc,
        )
        return out[0]

    def verify_batch(
        self,
        cands: list,
        query_points,
        query_mask,
        match_points,  # (C, N, D) stacked candidate keyframe scans
        match_mask,  # (C, N)
        T_preds=None,  # (C, D+1, D+1) odometry-predicted X_i⁻¹ X_j, or None
        query_desc=None,
        max_devs=None,  # (C,) per-candidate dev-gate radii (m); None = the
        # scalar cfg.verify_max_dev for every candidate
    ) -> list:
        """Geometrically verify ALL candidates of a keyframe in one dispatch.

        Coarse-to-fine ICP over a (candidates × yaw-hypotheses) grid — one
        nested-vmap program instead of per-candidate host round-trips
        (VERDICT r1 item 6: sequential verification was the scaling cliff for
        KITTI-00-length logs). Per candidate the yaw hypotheses are the top
        descriptor shifts plus the cardinal yaws; the best-rmse lock that
        passes the gates wins.

        Gates (per candidate): rmse ≤ verify_max_rmse, inliers ≥ 30% of the
        query, and — when T_preds is given — the measured translation within
        verify_max_dev of the odometry prediction. In self-similar worlds a
        *wrong* lock can have low rmse (structure repeats every grid period);
        the consistency gate rejects those aliases while true loops (drift ≪
        gating_radius) pass.

        query_desc: explicit (R, S) query descriptor; defaults to the stored
        descriptor at cands[0].query_idx. relocalize passes it explicitly —
        its query is not a stored keyframe, and staging a phantom entry in
        the shared store would be non-reentrant.

        Returns a list aligned with `cands`: LoopClosure (T_ij with
        i = match (earlier), j = query (later)) or None per candidate.
        """
        if not cands:
            return []
        s_sec = self.cfg.descriptor_sectors
        if query_desc is None:
            query_desc = self._descs[cands[0].query_idx]
        if self._descs_dev is None or self._n_dev != len(self._descs):
            self._sync_device_store()
        d = int(np.asarray(query_points).shape[1])
        qp = jnp.asarray(query_points, jnp.float32)
        qm = jnp.asarray(query_mask)
        qd = jnp.asarray(query_desc, jnp.float32)
        mp_all = jnp.asarray(match_points, jnp.float32)
        mm_all = jnp.asarray(match_mask)
        midx = jnp.asarray([c.match_idx for c in cands], jnp.int32)
        # chunk the candidate axis: transient NN buffers inside the nested
        # vmap scale ~C x, which at 16k scan capacity would OOM with all
        # topk candidates in one program (ADVICE r2). Chunk sizes retrace at
        # most twice (full chunk + remainder).
        chunk = self.cfg.verify_chunk or len(cands)
        rm_l, in_l, t_l = [], [], []
        for c0 in range(0, len(cands), chunk):
            c1 = min(c0 + chunk, len(cands))
            fine = _batched_verify(
                qp, qm,
                mp_all[c0:c1], mm_all[c0:c1],
                qd, self._descs_dev[midx[c0:c1]],
                cfg_coarse=self.icp_coarse,
                cfg_fine=self.icp_fine,
                sectors=s_sec,
                dim=d,
                n_yaws=getattr(self.cfg, "verify_yaws", 8),
            )
            rm_l.append(np.asarray(fine.rmse, np.float64))
            in_l.append(np.asarray(fine.n_inliers))
            t_l.append(np.asarray(fine.T, np.float64))
        rmses = np.concatenate(rm_l)  # (C, Y)
        inls = np.concatenate(in_l)  # (C, Y)
        Ts = np.concatenate(t_l)  # (C, Y, d+1, d+1)
        n_valid = int(np.asarray(query_mask).sum())
        ok = (rmses <= self.cfg.verify_max_rmse) & (
            inls >= 0.3 * max(n_valid, 1)
        )
        if T_preds is not None and self.cfg.verify_max_dev > 0:
            t_dev = np.linalg.norm(
                Ts[:, :, :d, d] - np.asarray(T_preds)[:, None, :d, d], axis=-1
            )
            allowed = (
                np.full(len(cands), self.cfg.verify_max_dev)
                if max_devs is None else np.asarray(max_devs, np.float64)
            )
            ok &= t_dev <= allowed[:, None]
        out = []
        for c, cand in enumerate(cands):
            if not ok[c].any():
                out.append(None)
                continue
            best = int(np.argmin(np.where(ok[c], rmses[c], np.inf)))
            out.append(
                LoopClosure(
                    i=cand.match_idx,
                    j=cand.query_idx,
                    T_ij=Ts[c, best],
                    rmse=float(rmses[c, best]),
                    n_inliers=int(inls[c, best]),
                )
            )
        return out

    def verify_keyframe_candidates(
        self,
        kf_idx: int,
        query_points,
        query_mask,
        scans_pts,
        scans_msk,
        kf_frames: list,
        kf_poses: list,
        pose,
        accepted: Optional[list] = None,
    ):
        """Candidate search + batched verification for one new keyframe.

        The shared front-end hook used by Slam2D and Slam3D (their loops
        were previously copy-pasted): gated candidates over the device
        store, then ONE nested-vmap verify_batch dispatch with the
        odometry-predicted relative poses as consistency gates. `kf_poses`
        and `pose` use the same (d+1, d+1) convention as the scans (SE(2)
        3x3 for 2D, SE(3) 4x4 for 3D). Returns (n_candidates, accepted
        closures list).

        `accepted` (the run's accepted-closure list so far) enables the
        closure_dedup_kf region dedup: candidates whose (query, match) pair
        falls within an already-closed revisit region are dropped BEFORE
        the verification dispatch — at multi-lap density most keyframes of
        a revisited stretch would otherwise re-verify the same seam
        (BASELINE.md r4 endurance2: the backend wall).

        verify_stride > 1 decimates both scans before the verification ICP
        (see BackendConfig.verify_stride).
        """
        cands = self.candidates(kf_idx)
        dd = getattr(self.cfg, "closure_dedup_kf", 0)
        if dd > 0 and accepted:
            cands = [
                c for c in cands
                if not any(
                    abs(c.match_idx - lc.i) <= dd and abs(kf_idx - lc.j) <= dd
                    for lc in accepted
                )
            ]
        if not cands:
            return 0, []
        stride = max(1, getattr(self.cfg, "verify_stride", 1))
        query_points = np.asarray(query_points)[::stride]
        query_mask = np.asarray(query_mask)[::stride]
        mp = np.stack(
            [scans_pts[kf_frames[c.match_idx]][::stride] for c in cands]
        )
        mm = np.stack(
            [scans_msk[kf_frames[c.match_idx]][::stride] for c in cands]
        )
        T_preds = np.stack([
            np.linalg.inv(kf_poses[c.match_idx]) @ pose for c in cands
        ])
        max_devs = None
        if self.cfg.verify_drift_rate > 0:
            # a true closure's deviation from the odometry prediction IS the
            # drift accumulated over the path between the keyframes — widen
            # the gate with odometry path length (see BackendConfig)
            t_kf = np.asarray([np.asarray(p)[:-1, -1] for p in kf_poses])
            seg = np.linalg.norm(np.diff(t_kf, axis=0), axis=1)
            cum = np.concatenate([[0.0], np.cumsum(seg)])
            q = cands[0].query_idx
            max_devs = np.asarray([
                max(
                    self.cfg.verify_max_dev,
                    self.cfg.verify_drift_rate * abs(cum[q] - cum[c.match_idx]),
                )
                for c in cands
            ])
        lcs = self.verify_batch(
            cands, query_points, query_mask, mp, mm, T_preds=T_preds,
            max_devs=max_devs,
        )
        return len(cands), [lc for lc in lcs if lc is not None]

    def relocalize(
        self,
        query_points,
        query_mask,
        kf_scans,
        kf_poses,
        topk: int = 3,
    ):
        """Global relocalization: place a scan in the existing keyframe map.

        No odometry prior exists (kidnapped-robot case), so no separation or
        position gating — pure descriptor ranking over ALL keyframes, then
        multi-yaw geometric verification of the top candidates. Returns
        (pose (4,4) or (3,3), match_idx, rmse) or None. A capability the
        reference never had (its only state was the live run).
        """
        if not self._descs:
            return None
        d = scan_context(
            jnp.asarray(query_points, jnp.float32),
            jnp.asarray(query_mask),
            rings=self.cfg.descriptor_rings,
            sectors=self.cfg.descriptor_sectors,
            max_range=self.max_range,
        )
        descs = jnp.asarray(np.stack(self._descs))
        scores, shifts = shift_match_scores(d, descs)
        scores = np.asarray(scores)
        shifts = np.asarray(shifts)
        n_q = len(self._descs)  # informational query index (not stored)
        qd = np.asarray(d)
        for m in np.argsort(-scores)[:topk]:
            yaw = shifts[m] * 2 * np.pi / self.cfg.descriptor_sectors
            if yaw > np.pi:
                yaw -= 2 * np.pi
            cand = LoopCandidate(
                query_idx=n_q, match_idx=int(m),
                score=float(scores[m]), yaw=float(yaw),
            )
            lc = self.verify(
                cand,
                query_points, query_mask,
                kf_scans[m][0], kf_scans[m][1],
                query_desc=qd,
            )
            if lc is not None:
                pose = np.asarray(kf_poses[m]) @ lc.T_ij
                return pose, int(m), lc.rmse
        return None
