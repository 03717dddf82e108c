"""Tile-local one-hot neighbor structure: the gather as a matmul.

It was designed for an accelerator on which XLA's dynamic gather cost a
fixed time per gathered *row*, so that the per-step neighbor gather (N*K
rows) dominated the MD step; whether it pays on the H100 is unmeasured.
This module replaces the gather with:

1. a spatial sort of atoms into 128-atom *bricks* (so each tile's
   neighbors cluster into a small neighborhood);
2. per tile: the neighborhood atom-id list (S ids) and a static one-hot
   selection matrix (128*K, S) rebuilt with the neighbor list;
3. per force evaluation: one small row gather (T*S rows, ~5x fewer) plus
   a batched matmul ``onehot @ neighborhood_positions`` does the
   "gather", exactly (0/1 weights; default matmul precision is set to
   'highest' package-wide so f32 values survive bit-exactly).

The atom *reordering is physical state*: positions/velocities are sorted
once at construction (single-species boxes — the permutation is
transparent); the neighbor structure is rebuilt periodically like a
Verlet list.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import box as B
from . import neighbor as NB


class OneHotNeighbors(NamedTuple):
    nbh_ids: jax.Array  # (T, S) int32 neighborhood atom ids (N = pad)
    onehot: jax.Array  # (T, 128 * K, S) selection matrix
    mask: jax.Array  # (T, 128, K) bool
    self_ids: jax.Array  # (T, 128) int32 — tile atom ids (identity here)


@dataclass(frozen=True)
class OneHotSpec:
    nspec: NB.NeighborSpec
    k: int  # neighbors kept per atom
    s: int  # neighborhood capacity per tile
    tile: int = 128


def spatial_sort(pos: np.ndarray, h: np.ndarray, brick: float) -> np.ndarray:
    """Permutation ordering atoms into spatial bricks of edge ~`brick`."""
    L = np.array([h[0, 0], h[1, 1], h[2, 2]])
    nb = np.maximum(1, np.floor(L / brick).astype(int))
    s = pos @ np.linalg.inv(np.asarray(h)).T
    s -= np.floor(s)
    bxyz = np.minimum((s * nb).astype(int), nb - 1)
    bid = (bxyz[:, 0] * nb[1] + bxyz[:, 1]) * nb[2] + bxyz[:, 2]
    return np.argsort(bid, kind="stable")


def derive_onehot_spec(
    n_atoms: int, h0: np.ndarray, cutoff: float, skin: float = 1.0, k: int = 20
) -> OneHotSpec:
    """Pick S from brick geometry: a 128-atom brick dilated by r_list."""
    nspec = NB.derive_spec(n_atoms, h0, cutoff=cutoff, skin=skin, k_max=k)
    L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]])
    density = n_atoms / float(np.prod(L))
    brick_vol = 128.0 / density
    edge = brick_vol ** (1.0 / 3.0)
    r = cutoff + skin
    nbh_atoms = density * (edge + 2 * r) ** 3
    s = int(np.ceil(min(nbh_atoms * 1.15, n_atoms) / 128.0)) * 128
    return OneHotSpec(nspec=nspec, k=k, s=s)


def build_onehot(spec: OneHotSpec, pos: jax.Array, h: jax.Array) -> OneHotNeighbors:
    """Rebuild the tile-local structure from the current configuration."""
    n = pos.shape[0]
    tile = spec.tile
    n_pad = ((n + tile - 1) // tile) * tile
    T = n_pad // tile
    K, S = spec.k, spec.s

    nbr = NB.build(spec.nspec, pos, h)  # (N, K)
    idx = jnp.concatenate(
        [nbr.idx, jnp.full((n_pad - n, K), n, dtype=jnp.int32)], axis=0
    ) if n_pad > n else nbr.idx
    msk = jnp.concatenate(
        [nbr.mask, jnp.zeros((n_pad - n, K), dtype=bool)], axis=0
    ) if n_pad > n else nbr.mask

    idx_t = idx.reshape(T, tile * K)
    msk_t = msk.reshape(T, tile, K)

    # neighborhood = sorted unique neighbor ids per tile (pad with n)
    def per_tile(ids, m):
        ids = jnp.where(m.reshape(-1), ids, n)
        uniq = jnp.unique(ids, size=S, fill_value=n)
        local = jnp.searchsorted(uniq, ids)
        return uniq.astype(jnp.int32), local.astype(jnp.int32)

    nbh_ids, local = jax.vmap(per_tile)(idx_t, msk_t)
    # bf16 storage: entries are exactly 0/1, so the matmul stays exact
    # while halving the structure's memory footprint and read traffic
    onehot = jax.nn.one_hot(local, S, dtype=jnp.bfloat16)  # (T, tile*K, S)
    onehot = onehot * msk_t.reshape(T, tile * K, 1).astype(jnp.bfloat16)
    self_ids = jnp.arange(n_pad, dtype=jnp.int32).reshape(T, tile)
    return OneHotNeighbors(nbh_ids=nbh_ids, onehot=onehot, mask=msk_t,
                           self_ids=self_ids)


def neighbor_positions(
    pos: jax.Array, h: jax.Array, oh: OneHotNeighbors
) -> tuple[jax.Array, jax.Array]:
    """Minimum-image displacements via the one-hot matmul.

    Returns (drT (3, K, N_pad), maskT (K, N_pad)) in the atom-minor layout
    the force fields use.
    """
    n = pos.shape[0]
    T, S = oh.nbh_ids.shape
    tile = oh.self_ids.shape[1]
    K = oh.mask.shape[2]
    pos_pad = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)], axis=0)
    nbh_pos = pos_pad[oh.nbh_ids]  # (T, S, 3) — T*S rows only
    # bf16 matmuls with a 3-way significand split of the positions:
    # the one-hot entries are exactly representable, so hi+mid+lo recovers
    # ~24 mantissa bits (~1e-6 A at box scale) with native-speed matmuls.
    if pos.dtype == jnp.float32:
        hi = nbh_pos.astype(jnp.bfloat16)
        r1 = nbh_pos - hi.astype(jnp.float32)
        mid = r1.astype(jnp.bfloat16)
        lo = (r1 - mid.astype(jnp.float32)).astype(jnp.bfloat16)
        packed = jnp.concatenate([hi, mid, lo], axis=-1)  # (T, S, 9)
        out = jnp.einsum(
            "tks,tsd->tkd", oh.onehot, packed,
            preferred_element_type=jnp.float32,
        )  # single pass over the one-hot
        gathered = out[..., 0:3] + out[..., 3:6] + out[..., 6:9]
    else:
        gathered = jnp.einsum(
            "tks,tsd->tkd", oh.onehot.astype(pos.dtype), nbh_pos
        )  # (T, tile*K, 3)
    gathered = gathered.reshape(T, tile, K, 3)
    center = pos_pad[oh.self_ids]  # (T, tile, 3) — contiguous rows
    dr = gathered - center[:, :, None, :]
    dr = B.min_image_disp(h, dr)
    # masked entries hold -center (one-hot row zero): zero them for safety
    dr = jnp.where(oh.mask[..., None], dr, 0.0)
    # to (3, K, N_pad)
    drT = jnp.transpose(dr.reshape(T * tile, K, 3), (2, 1, 0))
    maskT = oh.mask.reshape(T * tile, K).T
    return drT, maskT


@dataclass(frozen=True)
class SWOneHot:
    """Stillinger-Weber over the one-hot tile structure (moment-based
    three-body, physics identical to forcefields.sw.SW)."""

    sw: object
    spec: OneHotSpec

    @property
    def cutoff(self):
        return self.sw.cutoff

    def energy(self, pos: jax.Array, h: jax.Array, oh: OneHotNeighbors) -> jax.Array:
        p = self.sw
        rc = p.cutoff
        sig, eps = p.sigma, p.epsilon
        drT, maskT = neighbor_positions(pos, h, oh)  # (3, K, Np), (K, Np)
        r2 = jnp.sum(drT * drT, axis=0)
        m = maskT & (r2 < (rc - 1e-6) ** 2)
        r = jnp.sqrt(jnp.where(m, r2, 1.0))

        sr = sig / r
        srp = sr**p.p
        srq = sr**p.q
        expo = jnp.exp(sig / jnp.where(m, r - rc, -1.0))
        e2 = 0.5 * jnp.sum(jnp.where(m, p.A * eps * (p.B * srp - srq) * expo, 0.0))

        g = jnp.where(m, jnp.exp(p.gamma * sig / jnp.where(m, r - rc, -1.0)), 0.0)
        u = drT / r[None]
        gu = g[None] * u
        s = jnp.sum(g, axis=0)
        gsq = jnp.sum(g * g, axis=0)
        m2 = jnp.sum(jnp.sum(gu, axis=1) ** 2, axis=0)
        Q = jnp.einsum("akn,bkn->abn", gu, u)
        trq2 = jnp.einsum("abn,ban->n", Q, Q)
        c0 = p.costheta0
        e3_atom = (trq2 - gsq) - 2.0 * c0 * (m2 - gsq) + c0 * c0 * (s * s - gsq)
        return e2 + 0.5 * p.lam * eps * jnp.sum(e3_atom)
