"""Brute-force nearest neighbor in plain XLA (SURVEY.md §2b N3).

The plain-XLA answer to the reference's NN CUDA kernels (brute-force
`kernNearestNeighbor` and the KD-tree traversal; SURVEY.md §2a R5/R6 — mount
empty, §0): instead of pointer-chasing a tree, compute the (chunked) dense
distance matrix ‖a‖² + ‖b‖² − 2·A·Bᵀ as a matmul and argmin it. Padded
slots carry the PAD_COORD sentinel so they never win the argmin against any
real point — no mask plumbing into the hot loop.

This version bounds memory by chunking the source axis with lax.map: each
step writes a (chunk, N) f32 distance block to device memory and reads it
back. It is the CPU path and the reference the Pallas kernel (nn_pallas.py)
is checked against; the kernel keeps the running argmin in registers and
never writes the distance matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def nn_bruteforce_xla(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    chunk: int = 2048,
    precision=lax.Precision.HIGHEST,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """For each src point the index + squared distance of its nearest dst point.

    src: (M, D), dst: (N, D) float32 (D is typically 2 or 3, zero-padded by
    the caller if desired). Returns (idx (M,) int32, dist_sq (M,) float32).
    """
    m = src.shape[0]
    dst_sq = jnp.sum(dst * dst, axis=-1)  # (N,)

    def one_chunk(a):  # a: (chunk, D)
        a_sq = jnp.sum(a * a, axis=-1)  # (chunk,)
        # (chunk, N) distance matrix tile; the cross term is one matmul
        g = jnp.dot(a, dst.T, precision=precision)
        d = a_sq[:, None] + dst_sq[None, :] - 2.0 * g
        idx = jnp.argmin(d, axis=1).astype(jnp.int32)
        best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
        return idx, jnp.maximum(best, 0.0)

    if m <= chunk:
        return one_chunk(src)

    # pad M to a multiple of chunk, scan over chunks
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    src_p = jnp.pad(src, ((0, pad), (0, 0)))
    chunks = src_p.reshape(n_chunks, chunk, src.shape[1])
    idx, d2 = lax.map(one_chunk, chunks)
    return idx.reshape(-1)[:m], d2.reshape(-1)[:m]


def knn_bruteforce_xla(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    k: int,
    chunk: int = 1024,
    precision=lax.Precision.HIGHEST,
    approx: bool = False,
    oversample: int = 0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """k nearest dst indices per src point: (M, k) idx, (M, k) dist_sq.

    Used by normal estimation on unorganized clouds (SURVEY.md §2b N8).
    approx=True uses `lax.approx_min_k` (a partial-reduce top-k that is
    approximate on some accelerators and exact on the CPU and the GPU).
    oversample > 1 (with approx) fetches k × oversample approximate
    candidates, then takes the exact top-k among them — the candidate
    VALUES are exact f32, so the rescore costs a tiny (M, k·oversample)
    top_k and the effective recall of the true top-k approaches 1.
    """
    m = src.shape[0]
    n = dst.shape[0]
    dst_sq = jnp.sum(dst * dst, axis=-1)
    kk = min(k * oversample, n) if (approx and oversample > 1) else k

    def one_chunk(a):
        a_sq = jnp.sum(a * a, axis=-1)
        g = jnp.dot(a, dst.T, precision=precision)
        d = a_sq[:, None] + dst_sq[None, :] - 2.0 * g
        if approx:
            neg_d, idx = lax.approx_max_k(-d, kk)
            if kk > k:
                neg_d, sel = lax.top_k(neg_d, k)  # exact among candidates
                idx = jnp.take_along_axis(idx, sel, axis=1)
        else:
            neg_d, idx = lax.top_k(-d, k)
        return idx.astype(jnp.int32), jnp.maximum(-neg_d, 0.0)

    if m <= chunk:
        return one_chunk(src)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    src_p = jnp.pad(src, ((0, pad), (0, 0)))
    chunks = src_p.reshape(n_chunks, chunk, src.shape[1])
    idx, d2 = lax.map(one_chunk, chunks)
    return idx.reshape(-1, k)[:m], d2.reshape(-1, k)[:m]
