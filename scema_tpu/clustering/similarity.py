"""Pairwise L2 distances between strain-history splines — the on-device
replacement for the reference's O(N^2) MPI ring exchange.

The reference ring-passes every rank's splines around all ranks and
L2-compares received histories against local ones
(compare_histories_with_all_ranks, strain2spline.h:546-614) — a
ring-attention-shaped communication pattern.  On one device the whole
comparison is a blockwise distance computation; for sharded histories the
same computation runs under shard_map with an all_gather
(parallel/mesh_utils.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def pairwise_l2(splines: jax.Array, block: int = 256) -> jax.Array:
    """(n, d) -> (n, n) L2 distance matrix (compare_L2_norm semantics,
    strain2spline.h:469-487: plain sqrt of summed squared differences).

    Computed blockwise from direct differences rather than the
    |a|^2+|b|^2-2ab matmul identity: the identity cancels catastrophically
    (error ~ sqrt(eps)*|s|), which in float32 rivals the similarity
    threshold (1e-6, docs/configuration.md) — false edges would merge
    distinct strain histories.  Direct differencing keeps the error
    relative to the distance itself.  Memory stays at block*n*d.
    """
    n, d = splines.shape
    if n <= block:
        diff = splines[:, None, :] - splines[None, :, :]
        return jnp.sqrt(jnp.sum(diff * diff, axis=-1))

    pad = (-n) % block
    padded = jnp.pad(splines, ((0, pad), (0, 0)))
    blocks = padded.reshape(-1, block, d)

    def row_block(b):
        diff = b[:, None, :] - splines[None, :, :]
        return jnp.sqrt(jnp.sum(diff * diff, axis=-1))

    out = jax.lax.map(row_block, blocks)  # (nb, block, n)
    return out.reshape(-1, n)[:n]


def similarity_adjacency(
    splines: jax.Array, flagged: jax.Array, threshold: float
) -> jax.Array:
    """Boolean adjacency: dist < threshold between distinct flagged qps.

    Matches choose_most_similar_history's edge criterion
    (strain2spline.h:265-274: ``candidate_diff < threshold``) over the
    pairs enumerated by the ring comparison (flagged vs flagged, i != j).
    """
    d = pairwise_l2(splines)
    n = splines.shape[0]
    off_diag = ~jnp.eye(n, dtype=bool)
    return (d < threshold) & off_diag & flagged[:, None] & flagged[None, :]
