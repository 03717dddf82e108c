"""Neighbor lists: dense O(N^2) for small boxes, cell-binned
candidates for large ones — both with static shapes.

Replaces LAMMPS's ``neighbor 2.0 bin`` / ``neigh_modify every 1 delay 5``
machinery (lammps_scripts in.set.lammps).  Design (static shapes, masking
over dynamic control flow):

* A *full* neighbor list (each pair appears in both rows) of fixed width K:
  ``idx (N, K) int32`` + ``mask (N, K) bool``.  Forces then need no scatter
  — each atom sums over its own row (Newton-off, compute-rich).
* Small N (< n2_threshold): one masked N^2 distance matrix, top-K by
  distance via top_k.  This is a dense, regular computation.
* Large N: bin atoms into cells of edge >= cutoff via a sort by cell id,
  gather the 27 neighboring cells' occupants (fixed capacity per cell) as
  candidates, then top-K compact.  All static shapes; occupancy overflow is
  guarded by a generous capacity factor.

Lists are built with a skin (reference: 2.0 A) and reused for
``rebuild_every`` steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import box as B


class NeighborList(NamedTuple):
    idx: jax.Array  # (N, K) int32 neighbor indices (self-padded when invalid)
    mask: jax.Array  # (N, K) bool


@dataclass(frozen=True)
class NeighborSpec:
    """Static neighbor-list configuration, fixed at trace time."""

    cutoff: float  # interaction cutoff
    skin: float = 2.0
    k_max: int = 64  # neighbor-list width
    n2_threshold: int = 1024  # below this, use the dense N^2 path
    cells: tuple[int, int, int] = (0, 0, 0)  # 0 = derive at build time
    cell_capacity: int = 32

    @property
    def r_list(self) -> float:
        return self.cutoff + self.skin


def derive_spec(n_atoms: int, h0: np.ndarray, cutoff: float, skin: float = 2.0,
                k_max: int = 64) -> NeighborSpec:
    """Choose static cell grid from the initial box (with deformation margin)."""
    r = cutoff + skin
    L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]], dtype=float)
    # 20% margin for box shrinkage under deformation
    nc = np.maximum(1, np.floor(L / (1.2 * r)).astype(int))
    if (nc < 3).any():
        # fewer than 3 cells along an axis makes the 27-stencil wrap onto
        # duplicate cells, crowding k_max with repeats — use the dense path
        return NeighborSpec(cutoff=cutoff, skin=skin, k_max=k_max,
                            n2_threshold=n_atoms)
    density = n_atoms / float(np.prod(L))
    cap = int(np.ceil(density * np.prod(L / np.maximum(nc, 1)) * 2.0)) + 4
    return NeighborSpec(
        cutoff=cutoff,
        skin=skin,
        k_max=k_max,
        cells=(int(nc[0]), int(nc[1]), int(nc[2])),
        cell_capacity=cap,
    )


def required_k(n_atoms: int, h0: np.ndarray, r_list: float,
               margin: float = 1.3, pad: int = 8) -> int:
    """Uniform-density estimate of the list width needed to hold every
    candidate within ``r_list``.

    A fixed-width list sized below the true in-cutoff coordination silently
    drops genuine pairs (wrong forces/virials with no error), so callers
    should size ``k_max`` from this rather than a hand-picked constant
    (crystals with known shell structure may deliberately use less —
    validated by ``max_in_range``)."""
    vol = abs(float(np.linalg.det(np.asarray(h0, dtype=float))))
    density = n_atoms / vol
    k = int(np.ceil(density * (4.0 / 3.0) * np.pi * r_list**3 * margin)) + pad
    return max(1, min(k, n_atoms - 1))


def max_in_range(pos, h, r: float, chunk: int = 1024) -> int:
    """Eager diagnostic: the exact maximum per-atom neighbor count within
    ``r`` (minimum-image).  O(N^2) in numpy, chunked — setup-time only."""
    pos = np.asarray(pos, dtype=float)
    h = np.asarray(h, dtype=float)
    ih = np.linalg.inv(h)
    worst = 0
    n = pos.shape[0]
    for i0 in range(0, n, chunk):
        blk = pos[i0:i0 + chunk]
        ds = (blk[:, None, :] - pos[None, :, :]) @ ih.T
        ds -= np.round(ds)
        dr = ds @ h.T
        r2 = np.einsum("ijk,ijk->ij", dr, dr)
        cnt = (r2 < r * r).sum(axis=1) - 1  # minus self
        worst = max(worst, int(cnt.max()))
    return worst


def max_cell_occupancy(spec: NeighborSpec, pos, h) -> int:
    """Eager diagnostic: the fullest cell's atom count under ``spec.cells``
    (atoms beyond ``cell_capacity`` are silently dropped from the slot grid
    — free-streaming ghosts — so callers must check this at setup)."""
    if spec.cells == (0, 0, 0):
        return 0
    pos = np.asarray(pos, dtype=float)
    h = np.asarray(h, dtype=float)
    nc = np.asarray(spec.cells)
    s = pos @ np.linalg.inv(h).T
    s -= np.floor(s)
    cxyz = np.clip((s * nc).astype(int), 0, nc - 1)
    cid = (cxyz[:, 0] * nc[1] + cxyz[:, 1]) * nc[2] + cxyz[:, 2]
    return int(np.bincount(cid).max())


def _topk_compact(dr2: jax.Array, cand_idx: jax.Array, valid: jax.Array, k: int,
                  r2_cut: float) -> NeighborList:
    """Keep the k nearest valid candidates per row.

    Uses lax.top_k on negated distances — O(n_cand * k) per row instead
    of a full argsort.
    """
    big = jnp.asarray(1e30, dtype=dr2.dtype)
    keyed = jnp.where(valid & (dr2 < r2_cut), dr2, big)
    neg_d, order = jax.lax.top_k(-keyed, k)
    idx = jnp.take_along_axis(cand_idx, order, axis=1)
    mask = -neg_d < big
    n = dr2.shape[0]
    self_idx = jnp.arange(n, dtype=jnp.int32)[:, None]
    return NeighborList(
        idx=jnp.where(mask, idx, self_idx).astype(jnp.int32), mask=mask
    )


def build_dense(spec: NeighborSpec, pos: jax.Array, h: jax.Array) -> NeighborList:
    """O(N^2) masked neighbor search (small boxes)."""
    n = pos.shape[0]
    dr = B.min_image_disp(h, pos[None, :, :] - pos[:, None, :])
    dr2 = jnp.sum(dr * dr, axis=-1)
    cand = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (n, n))
    valid = ~jnp.eye(n, dtype=bool)
    return _topk_compact(dr2, cand, valid, min(spec.k_max, n - 1), spec.r_list**2)


_CELL_OFFSETS = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int32,
)


def build_cells_structured(
    spec: NeighborSpec, pos: jax.Array, h: jax.Array
) -> NeighborList:
    """Cell-binned neighbor search without per-atom candidate gathers.

    Candidates come from *structured permutations of the cell grid*: atoms
    are scattered into a (cap, C) slot grid once, each of the 27 neighbor
    relations is a static permutation of the C axis, and distances are
    computed on dense (cap_i, cap_j, C) blocks — regular memory movement
    only.  The per-atom top-K compaction then runs on a (cap*C, 27*cap)
    table.
    """
    n = pos.shape[0]
    ncx, ncy, ncz = spec.cells
    C = ncx * ncy * ncz
    cap = spec.cell_capacity
    nc = jnp.asarray([ncx, ncy, ncz])

    s = B.to_fractional(h, pos)
    s = s - jnp.floor(s)
    cxyz = jnp.clip((s * nc).astype(jnp.int32), 0, nc - 1)
    cid = (cxyz[:, 0] * ncy + cxyz[:, 1]) * ncz + cxyz[:, 2]
    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    first = jnp.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = jnp.arange(n) - first
    grid = jnp.full((cap, C), n, dtype=jnp.int32)
    ok = rank < cap
    grid = grid.at[jnp.clip(rank, 0, cap - 1), cid_sorted].set(
        jnp.where(ok, order, n).astype(jnp.int32), mode="drop"
    )  # (cap, C) atom ids

    pos_pad = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)], axis=0)
    pos_g = pos_pad[grid.reshape(-1)].reshape(cap, C, 3)
    pos_g = jnp.transpose(pos_g, (2, 0, 1))  # (3, cap, C)
    occ = grid < n

    # static cell permutations for the 27 offsets
    idxC = np.arange(ncx * ncy * ncz)
    iz = idxC % ncz
    iy = (idxC // ncz) % ncy
    ix = idxC // (ncy * ncz)
    ih = B.inv_h(h)

    d2_blocks = []
    id_blocks = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                perm = jnp.asarray(
                    (((ix + dx) % ncx) * ncy + (iy + dy) % ncy) * ncz
                    + (iz + dz) % ncz,
                    dtype=jnp.int32,
                )
                npos = jnp.take(pos_g, perm, axis=-1)  # (3, cap, C)
                nids = jnp.take(grid, perm, axis=-1)  # (cap, C)
                nocc = jnp.take(occ, perm, axis=-1)
                dr = npos[:, None, :, :] - pos_g[:, :, None, :]
                ds = jnp.einsum("ab,bijc->aijc", ih, dr)
                ds = ds - jnp.round(ds)
                dr = jnp.einsum("ab,bijc->aijc", h, ds)
                r2 = jnp.sum(dr * dr, axis=0)  # (cap_i, cap_j, C)
                valid = occ[:, None, :] & nocc[None, :, :]
                if (dx, dy, dz) == (0, 0, 0):
                    valid = valid & ~jnp.eye(cap, dtype=bool)[:, :, None]
                d2_blocks.append(jnp.where(valid, r2, 1e30))
                id_blocks.append(jnp.broadcast_to(nids[None], (cap, cap, C)))

    d2 = jnp.concatenate(d2_blocks, axis=1)  # (cap_i, 27*cap, C)
    ids = jnp.concatenate(id_blocks, axis=1)
    # per-atom rows: (cap_i * C, 27*cap) with candidates minor for top_k
    d2r = jnp.transpose(d2, (0, 2, 1)).reshape(cap * C, 27 * cap)
    idr = jnp.transpose(ids, (0, 2, 1)).reshape(cap * C, 27 * cap)
    valid_r = d2r < spec.r_list**2
    nl_slots = _topk_compact(d2r, idr, valid_r, spec.k_max, spec.r_list**2)

    # scatter slot rows back to atom order
    slot_atom = grid.reshape(-1)  # (cap*C,)
    idx_out = jnp.full((n + 1, spec.k_max), n, dtype=jnp.int32)
    msk_out = jnp.zeros((n + 1, spec.k_max), dtype=bool)
    idx_out = idx_out.at[slot_atom].set(nl_slots.idx, mode="drop")
    msk_out = msk_out.at[slot_atom].set(nl_slots.mask, mode="drop")
    self_idx = jnp.arange(n, dtype=jnp.int32)[:, None]
    idx_n = jnp.where(msk_out[:n], idx_out[:n], self_idx)
    return NeighborList(idx=idx_n, mask=msk_out[:n])


def build_cells(spec: NeighborSpec, pos: jax.Array, h: jax.Array) -> NeighborList:
    """Cell-binned neighbor search with static cell grid and capacity."""
    n = pos.shape[0]
    ncx, ncy, ncz = spec.cells
    ncells = ncx * ncy * ncz
    cap = spec.cell_capacity
    nc = jnp.asarray([ncx, ncy, ncz])

    s = B.to_fractional(h, pos)
    s = s - jnp.floor(s)
    cxyz = jnp.clip((s * nc).astype(jnp.int32), 0, nc - 1)  # (N, 3)
    cid = (cxyz[:, 0] * ncy + cxyz[:, 1]) * ncz + cxyz[:, 2]  # (N,)

    # sort by cell; rank within each cell via first-occurrence search
    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    first = jnp.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = jnp.arange(n) - first
    # occupancy table (ncells, cap); overflow atoms (rank >= cap) are
    # dropped by the OOB scatter itself — clipping the rank instead would
    # make the overflow atom race the slot-(cap-1) occupant with
    # unspecified duplicate-index ordering, possibly erasing it
    occ = jnp.full((ncells, cap), n, dtype=jnp.int32)
    occ = occ.at[cid_sorted, rank].set(
        order.astype(jnp.int32), mode="drop"
    )

    # candidate ids from the 27 surrounding cells
    offs = jnp.asarray(_CELL_OFFSETS)  # (27, 3)
    ncell_xyz = cxyz[:, None, :] + offs[None, :, :]  # (N, 27, 3)
    ncell_xyz = jnp.mod(ncell_xyz, nc)
    ncell_id = (ncell_xyz[..., 0] * ncy + ncell_xyz[..., 1]) * ncz + ncell_xyz[..., 2]
    cand = occ[ncell_id].reshape(n, 27 * cap)  # (N, 27*cap)

    pos_pad = jnp.concatenate([pos, jnp.zeros((1, 3), dtype=pos.dtype)], axis=0)
    dr = B.min_image_disp(h, pos_pad[cand] - pos[:, None, :])
    dr2 = jnp.sum(dr * dr, axis=-1)
    valid = (cand < n) & (cand != jnp.arange(n, dtype=jnp.int32)[:, None])
    return _topk_compact(dr2, cand, valid, spec.k_max, spec.r_list**2)


def build(spec: NeighborSpec, pos: jax.Array, h: jax.Array) -> NeighborList:
    if pos.shape[0] <= spec.n2_threshold or spec.cells == (0, 0, 0):
        return build_dense(spec, pos, h)
    return build_cells_structured(spec, pos, h)


def neighbor_disp(pos: jax.Array, h: jax.Array, nbr: NeighborList) -> jax.Array:
    """Min-image displacement r_j - r_i for every list entry (N, K, 3)."""
    return B.min_image_disp(h, pos[nbr.idx] - pos[:, None, :])
