"""Fixed-capacity voxel-deduplicated 3D map (SURVEY.md §2b N11).

The scan-to-map model of BASELINE.json config 4. Static-shape design: the map is
a static-shape point store (capacity C) with a validity mask; insertion is a
*sort-based* voxel dedup — concatenate existing + new points, lexsort by
quantized voxel coordinates (stable, existing points first), keep the first
point per voxel, and compact back to capacity. Everything is XLA sorts and
gathers: no hash table, no pointer chasing, no dynamic shapes — the idiomatic
replacement for a mutable voxel-hash map on GPU (SURVEY.md §2c).

Local-model extraction for ICP is a masked `top_k` by distance from the
current pose — a fixed-size nearest-subset query that keeps the downstream
distance-matrix kernel shapes static.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tpu_icp_slam.core.pointcloud import PAD_COORD

# quantized voxel coordinates live in [-2^19, 2^19); invalid slots sort last
_QMAX = 1 << 19
_QINVALID = _QMAX + 7


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VoxelMap:
    points: jnp.ndarray  # (C, 3) world frame; PAD_COORD sentinel when invalid
    normals: jnp.ndarray  # (C, 3) world frame; zeros when unknown
    mask: jnp.ndarray  # (C,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def create(capacity: int, dtype=jnp.float32) -> VoxelMap:
    return VoxelMap(
        points=jnp.full((capacity, 3), PAD_COORD, dtype=dtype),
        normals=jnp.zeros((capacity, 3), dtype=dtype),
        mask=jnp.zeros((capacity,), bool),
    )


def _quantize(pts: jnp.ndarray, msk: jnp.ndarray, voxel: float):
    q = jnp.floor(pts / voxel).astype(jnp.int32)
    q = jnp.clip(q, -_QMAX, _QMAX - 1)
    return jnp.where(msk[:, None], q, _QINVALID)


def insert(vm: VoxelMap, pts: jnp.ndarray, msk: jnp.ndarray, nrm: jnp.ndarray,
           *, voxel: float, center: jnp.ndarray | None = None) -> VoxelMap:
    """Merge a world-frame scan into the map with voxel dedup.

    Existing map points win ties inside a voxel (stable sort, map first), so
    the map doesn't drift with re-observation. On overflow:
    - with `center` (the current sensor position): SPATIAL eviction — the
      `cap` points nearest the sensor survive (the local-map policy of
      production lidar odometry). FIFO-keep is a trap: once the map fills,
      new terrain would never enter it and the vehicle outruns its own map
      (measured: tracking death exactly at capacity saturation).
    - without `center`: earliest-inserted points win (deterministic).
    """
    cap = vm.capacity
    all_pts = jnp.concatenate([vm.points, pts], axis=0)
    all_nrm = jnp.concatenate([vm.normals, nrm], axis=0)
    all_msk = jnp.concatenate([vm.mask, msk], axis=0)
    n_tot = all_pts.shape[0]

    q = _quantize(all_pts, all_msk, voxel)  # (T, 3)
    order = jnp.lexsort((jnp.arange(n_tot), q[:, 2], q[:, 1], q[:, 0]))
    qs = q[order]
    same_as_prev = jnp.all(qs == jnp.roll(qs, 1, axis=0), axis=1)
    same_as_prev = same_as_prev.at[0].set(False)
    keep = (~same_as_prev) & all_msk[order]

    # compact keepers to the front; `rank` holds positions into the
    # voxel-sorted space (keepers first, then by eviction priority)
    if center is not None:
        diff = all_pts[order] - center[None, :]
        prio = jnp.sum(diff * diff, axis=-1)  # nearest-to-sensor survives
    else:
        prio = order.astype(all_pts.dtype)  # earliest-inserted survives
    rank = jnp.lexsort((prio, ~keep))
    chosen = order[rank[:cap]]
    new_pts = all_pts[chosen]
    new_nrm = all_nrm[chosen]
    new_msk = keep[rank[:cap]]
    new_pts = jnp.where(new_msk[:, None], new_pts, PAD_COORD)
    new_nrm = jnp.where(new_msk[:, None], new_nrm, 0.0)
    return VoxelMap(points=new_pts, normals=new_nrm, mask=new_msk)


def insert_hash(vm: VoxelMap, pts: jnp.ndarray, msk: jnp.ndarray,
                nrm: jnp.ndarray, *, voxel: float,
                center: jnp.ndarray | None = None,
                table_mult: int = 2, probes: int = 8) -> VoxelMap:
    """Hash-probe voxel-dedup insert — the sort-free fast path.

    `insert` lexsorts map+scan (147k elements at the flagship regime, ~7.6
    ms/keyframe, the largest single op in the pipeline — r3 SOL
    decomposition). This variant never sorts the map side:

      1. map slots STAY PUT (no reshuffle); a fresh open-addressing hash
         table (table_mult x capacity, `probes` linear-probe rounds maps
         quantized voxel keys -> slot index) is built per insert with
         scatter-min + gather-verify — no pointer chasing, fixed shapes;
      2. the scan dedups internally with one small (N_new) sort;
      3. membership probes drop scan points whose voxel is already mapped
         (existing point wins, same tie policy as `insert`);
      4. surviving points scatter into victim slots — empty slots first,
         then (with `center`) the farthest-from-sensor occupied slots
         (the same spatial-eviction policy), nearest new points placed
         first; a victim is only overwritten when its eviction score is
         worse than the incoming point's.

    Differences vs `insert` (why it's a separate function, behind
    mapping.insert_backend): map points keep their slots between inserts
    (stable indices), eviction is lazy (only as many victims as needed),
    and hash-probe overflow (> `probes` collisions) can rarely admit a
    duplicate voxel — it wastes a slot, never loses data. Equivalence of
    the surviving voxel SET (no-eviction case) is test-enforced.
    """
    cap = vm.capacity
    n_new = pts.shape[0]
    tsize = table_mult * cap
    q_map = _quantize(vm.points, vm.mask, voxel)  # (C, 3)
    q_new = _quantize(pts, msk, voxel)  # (N, 3)

    def _hash(q):
        h = (q[:, 0].astype(jnp.uint32) * jnp.uint32(2654435761)
             ^ q[:, 1].astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
             ^ q[:, 2].astype(jnp.uint32) * jnp.uint32(0x85EBCA77))
        return (h % jnp.uint32(tsize)).astype(jnp.int32)

    # 1. build: scatter-min claims a slot; rounds move the unplaced to the
    # next probe offset. Entries still unplaced after `probes` rounds are
    # invisible to membership (harmless duplicate admission).
    empty = jnp.int32(cap)  # sentinel > any real index
    table = jnp.full((tsize,), empty, jnp.int32)
    h_map = _hash(q_map)
    idx_map = jnp.arange(cap, dtype=jnp.int32)
    placed = ~vm.mask
    for p in range(probes):
        slot = (h_map + p) % tsize
        attempt = jnp.where(placed, empty, idx_map)
        table = table.at[slot].min(attempt)
        placed = placed | (table[slot] == idx_map)

    # 2. scan-internal dedup: one small sort over the new points only
    order = jnp.lexsort(
        (jnp.arange(n_new), q_new[:, 2], q_new[:, 1], q_new[:, 0])
    )
    qs = q_new[order]
    dup = jnp.all(qs == jnp.roll(qs, 1, axis=0), axis=1).at[0].set(False)
    first_of_voxel = jnp.zeros((n_new,), bool).at[order].set(~dup)

    # 3. membership: probe the table, verify by exact quantized-key compare
    h_new = _hash(q_new)
    present = jnp.zeros((n_new,), bool)
    for p in range(probes):
        cand = table[(h_new + p) % tsize]  # (N,) slot or `empty`
        cand_q = q_map[jnp.minimum(cand, cap - 1)]
        hit = (cand < cap) & jnp.all(cand_q == q_new, axis=1)
        present = present | hit
    need = msk & first_of_voxel & ~present

    # 4. victims + placement
    if center is not None:
        c = center
    else:
        c = jnp.zeros((3,), pts.dtype)
    d2_slot = jnp.sum((vm.points - c[None, :]) ** 2, axis=-1)
    # empty slots score +inf (chosen first, always overwritable); occupied
    # slots score their eviction badness (distance from sensor)
    evict_score = jnp.where(vm.mask, d2_slot, jnp.inf)
    if center is None:
        # deterministic mode: never evict — only empty slots are victims
        evict_score = jnp.where(vm.mask, -jnp.inf, jnp.inf)
    k_victims = min(n_new, cap)
    v_score, v_slot = jax.lax.top_k(evict_score, k_victims)
    d2_new = jnp.sum((pts - c[None, :]) ** 2, axis=-1)
    rank_new = jnp.argsort(jnp.where(need, d2_new, jnp.inf))[:k_victims]
    src_ok = need[rank_new]
    better = v_score > d2_new[rank_new]  # inf (empty) always wins
    do = src_ok & better
    tgt = jnp.where(do, v_slot, cap)  # `cap` = dropped (out-of-range row)
    new_points = jnp.pad(vm.points, ((0, 1), (0, 0)))
    new_normals = jnp.pad(vm.normals, ((0, 1), (0, 0)))
    new_mask = jnp.pad(vm.mask, (0, 1))
    src_pts = jnp.where(do[:, None], pts[rank_new], PAD_COORD)
    src_nrm = jnp.where(do[:, None], nrm[rank_new], 0.0)
    new_points = new_points.at[tgt].set(src_pts)[:cap]
    new_normals = new_normals.at[tgt].set(src_nrm)[:cap]
    new_mask = new_mask.at[tgt].set(new_mask[tgt] | do)[:cap]
    return VoxelMap(points=new_points, normals=new_normals, mask=new_mask)


def extract_local(vm: VoxelMap, center: jnp.ndarray, size: int,
                  radius: float = 0.0, approx: bool = False):
    """Nearest `size` map points to `center`: (pts (S,3), nrm (S,3), msk (S,),
    r_cover ()).

    radius > 0 additionally gates by euclidean distance. Fixed output shape
    regardless of map occupancy (invalid slots keep the sentinel coordinate).
    r_cover is the model's coverage radius — the distance to the farthest
    selected point (or `radius` if that gates first). Scan points beyond
    r_cover have no genuine counterpart in the model and must not be matched
    against its boundary (scan_to_map gates on this).

    approx=True selects via `lax.approx_min_k` (recall_target 0.95): the local
    model drops ~5% of its true nearest points, which thins its density
    imperceptibly (the map is voxel-dense at `map_voxel` spacing) while
    skipping the exact top_k's full sort network (the per-frame extract is
    a visible share of the frame, r3 SOL decomposition).
    r_cover stays correct: it is the max distance of the SELECTED set.
    """
    diff = vm.points - center[None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(vm.mask, d2, jnp.inf)
    if approx:
        neg, idx = jax.lax.approx_max_k(-d2, size)
    else:
        neg, idx = jax.lax.top_k(-d2, size)
    msk = jnp.isfinite(neg)
    if radius > 0.0:
        msk = msk & (-neg <= radius * radius)
    # if the map still has free capacity the farthest-point bound is not a
    # coverage limit — everything known is in the model, so don't gate
    full = jnp.sum(vm.mask) > size
    r_sel = jnp.sqrt(jnp.maximum(-jnp.min(neg, initial=0.0, where=msk), 0.0))
    r_cover = jnp.where(full, r_sel, jnp.inf)
    if radius > 0.0:
        r_cover = jnp.minimum(r_cover, radius)
    # restore MAP order (voxel-key lexsort) in the local model: top_k
    # returns distance-from-center order, which scatters spatially-adjacent
    # map points across the whole index range — the rescore NN's
    # deal-interleave (nn_pallas.py) then loses its adjacency guarantee
    # (near-ties must be index-close to provably land in distinct shortlist
    # slots). Sorting the selected indices recovers the store's lexsort
    # adjacency; nothing downstream depends on extraction order.
    order = jnp.argsort(jnp.where(msk, idx, jnp.iinfo(jnp.int32).max))
    idx = idx[order]
    msk = msk[order]
    pts = jnp.where(msk[:, None], vm.points[idx], PAD_COORD)
    nrm = jnp.where(msk[:, None], vm.normals[idx], 0.0)
    return pts, nrm, msk, r_cover


def count(vm: VoxelMap) -> jnp.ndarray:
    return jnp.sum(vm.mask.astype(jnp.int32))


def render_png(vm: VoxelMap, path: str, trajectory=None,
               size: int = 1200) -> None:
    """Top-down map render (height-colored, trajectory red) — the headless
    stand-in for the reference's GL point view (SURVEY.md §2c, R2 row), 3D
    edition."""
    import numpy as np

    from tpu_icp_slam.obs.png import draw_path, plot, write_png

    pts = np.asarray(vm.points, np.float64)[np.asarray(vm.mask)]
    traj = (np.zeros((0, 2)) if trajectory is None
            else np.asarray(trajectory, np.float64)[:, :2])
    xy = np.concatenate([pts[:, :2], traj]) if len(pts) else traj
    img = np.full((size, size, 3), 255, np.uint8)
    if len(xy):
        lo, hi = xy.min(0) - 1.0, xy.max(0) + 1.0
        res = float(max(hi - lo)) / size
        if len(pts):
            z = pts[:, 2]
            t = (z - z.min()) / max(float(np.ptp(z)), 1e-6)
            rgb = np.stack([60 + 190 * t, 40 + 170 * t, 140 - 100 * t],
                           axis=1).astype(np.uint8)  # blue (low) → yellow
            order = np.argsort(z)  # higher points drawn last
            plot(img, pts[order, :2], lo, res, rgb[order])
        draw_path(img, traj, lo, res)
    write_png(path, img)

