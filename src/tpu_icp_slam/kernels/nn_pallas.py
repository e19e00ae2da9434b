"""Brute-force nearest neighbour as one Pallas kernel, Triton route (N3).

Replaces the reference's brute-force and KD-tree NN kernels (SURVEY.md §2a
R5/R6; mount empty, §0) with a fused running argmin: the M×N distance
matrix never exists in device memory. The XLA version (nn_xla.py) writes a
(chunk, N) f32 distance block per `lax.map` step and reads it back for the
argmin; here each block of source rows walks over the whole target cloud
and keeps its best distance and index in registers, so device memory sees
only the inputs (3 coordinates per point) and one store per source row.

Design for the GPU:
- Point clouds are passed coordinate-major, one 1-D array per coordinate,
  so every load is a contiguous vector.
- A 1-D grid over source blocks of BLOCK_M rows: 16,384 sources give 1,024
  blocks, several per SM on a 132-SM card. Blocks are independent.
- Inside a block, a `fori_loop` over target blocks of BLOCK_N points with a
  masked load (targets past N read as +inf and never win). The running
  minimum is kept elementwise in a (BLOCK_M, BLOCK_N) register tile, with
  the block number that set it, so the loop body is compare-and-select
  only; each row is reduced once after the loop.
- Distances in difference form Σ(a−b)² on the CUDA cores. With K = 2 or 3
  there is nothing for the tensor cores to do, and the difference form has
  none of the cancellation of ‖a‖² + ‖b‖² − 2a·b, so the picked distance is
  the exact f32 minimum.
- Tie rule: the lowest target index wins. A later block replaces a tile
  entry only when strictly smaller, and the final reduction takes the
  smallest index among the entries equal to the row minimum.

Callers pad clouds with the PAD_COORD sentinel (core.pointcloud); sentinel
targets are ordinary far points and lose on distance.

`interpret=True` runs the same kernel through the Pallas interpreter; the
wrapper uses it only when the default backend is the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Chosen by measurement on an H100 at 16,384 × 16,384, alone and batched 16
# deep (scripts/exp_nn_blocks.py; PERF.md, NN kernel).
BLOCK_M = 16
BLOCK_N = 64
NUM_WARPS = 8
NUM_STAGES = 3


def _nn_kernel(*refs, dim: int, n: int, block_m: int, block_n: int):
    src_refs = refs[:dim]
    dst_refs = refs[dim:2 * dim]
    idx_ref, d2_ref = refs[2 * dim:]
    rows = pl.ds(pl.program_id(0) * block_m, block_m)
    a = [r[rows][:, None] for r in src_refs]  # dim × (block_m, 1)

    def body(j, carry):
        # elementwise running min over target blocks: no cross-thread
        # reduction inside the loop, only compare-and-select per pair
        best, blk = carry
        start = j * block_n
        valid = start + jnp.arange(block_n) < n
        d2 = None
        for c in range(dim):
            b = plgpu.load(dst_refs[c].at[pl.ds(start, block_n)], mask=valid,
                           other=jnp.inf)
            diff = a[c] - b[None, :]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        take = d2 < best  # strict: the earliest block keeps a tie
        return jnp.where(take, d2, best), jnp.where(take, j, blk)

    init = (jnp.full((block_m, block_n), jnp.inf, jnp.float32),
            jnp.zeros((block_m, block_n), jnp.int32))
    best, blk = lax.fori_loop(0, pl.cdiv(n, block_n), body, init)
    # one reduction per row at the end; among equal minima the lowest
    # target index wins
    d2_min = jnp.min(best, axis=1)
    idx = blk * block_n + jnp.arange(block_n)[None, :]
    idx = jnp.where(best == d2_min[:, None], idx, jnp.iinfo(jnp.int32).max)
    idx_ref[rows] = jnp.min(idx, axis=1)
    d2_ref[rows] = d2_min


def _interpret_for_platform() -> bool:
    from tpu_icp_slam.kernels.nn import AUTO_BACKEND

    platform = jax.default_backend()
    if platform not in AUTO_BACKEND:
        raise RuntimeError(f"no NN kernel for platform {platform!r}")
    return platform == "cpu"


@functools.partial(
    jax.jit, static_argnames=("block_m", "block_n", "num_warps", "num_stages",
                              "interpret"))
def nn_bruteforce_pallas(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    block_m: int = BLOCK_M,
    block_n: int = BLOCK_N,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(M, D), (N, D) -> (idx (M,) int32, dist_sq (M,) f32), exact f32.

    Source rows are padded to a multiple of block_m (padded rows are sliced
    off); targets are not padded, the kernel masks the ragged last block.
    """
    if interpret is None:
        interpret = _interpret_for_platform()
    m, dim = src.shape
    n = dst.shape[0]
    mp = pl.cdiv(m, block_m) * block_m
    src_t = jnp.pad(src.astype(jnp.float32).T, ((0, 0), (0, mp - m)))
    dst_t = dst.astype(jnp.float32).T
    idx, d2 = pl.pallas_call(
        functools.partial(_nn_kernel, dim=dim, n=n, block_m=block_m,
                          block_n=block_n),
        out_shape=(jax.ShapeDtypeStruct((mp,), jnp.int32),
                   jax.ShapeDtypeStruct((mp,), jnp.float32)),
        grid=(mp // block_m,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="nn_argmin",
    )(*src_t, *dst_t)
    return idx[:m], d2[:m]
