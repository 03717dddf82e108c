"""Cell-grid interaction structure: gather-free pair computation.

The neighbor-list path (neighbor.py) costs one (N, K)-row gather per force
evaluation.  This module replaces the gather with a dense cell grid (its
cost on the H100 is unmeasured):

* atoms are binned into C = c1*c2*c3 cells (edge >= cutoff+skin) with a
  fixed per-cell capacity, stored as a slot grid ``(cap, C)`` with C padded
  to a multiple of 128;
* the 27 neighbor-cell relations are *static permutations* of the C axis,
  applied as one-hot matmuls (regular, no gathers);
* pair terms are computed on ``(cap_i, cap_j, C)`` blocks — minor dim C,
  fully vectorized;
* the SW three-body term uses the exact second-moment reduction (see
  forcefields/sw.py) so everything stays O(pairs).

One gather of cap*C rows (the slot fill) remains per evaluation — ~100x
fewer rows than the neighbor-list gather.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from . import box as B


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class GridSpec:
    cells: tuple[int, int, int]
    cap: int
    c_pad: int  # padded flat cell count (multiple of 128)
    perms: np.ndarray  # (27, c_pad) int32 — neighbor-cell permutations
    r_list: float

    @property
    def n_cells(self) -> int:
        return self.cells[0] * self.cells[1] * self.cells[2]


def derive_grid(n_atoms: int, h0: np.ndarray, cutoff: float, skin: float = 0.5,
                cap: int | None = None, margin: float = 1.15) -> GridSpec:
    """Static grid geometry from the initial box (deformation margin)."""
    r = cutoff + skin
    L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]], dtype=float)
    nc = np.maximum(1, np.floor(L / (margin * r)).astype(int))
    # grids need >= 3 cells per axis for distinct 27-stencil neighbors;
    # smaller boxes get a single-cell "grid" covering all pairs
    if (nc < 3).any():
        nc = np.array([1, 1, 1])
    c1, c2, c3 = int(nc[0]), int(nc[1]), int(nc[2])
    C = c1 * c2 * c3
    c_pad = _round_up(max(C, 128), 128)
    if cap is None:
        density = n_atoms / float(np.prod(L))
        cellvol = float(np.prod(L / nc))
        cap = int(np.ceil(density * cellvol * 2.0)) + 4
        cap = _round_up(cap, 8)

    # neighbor permutations: perm[o][c] = flat index of cell c's o-th
    # neighbor (periodic); padded cells map to themselves (empty anyway)
    offsets = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    if C == 1:
        offsets = [(0, 0, 0)]
    perms = np.zeros((len(offsets), c_pad), dtype=np.int32)
    idx = np.arange(C)
    iz = idx % c3
    iy = (idx // c3) % c2
    ix = idx // (c2 * c3)
    for o, (dx, dy, dz) in enumerate(offsets):
        nx = (ix + dx) % c1
        ny = (iy + dy) % c2
        nz = (iz + dz) % c3
        perms[o, :C] = (nx * c2 + ny) * c3 + nz
        perms[o, C:] = np.arange(C, c_pad)
    return GridSpec(cells=(c1, c2, c3), cap=int(cap), c_pad=int(c_pad),
                    perms=perms, r_list=r)


def build_grid(spec: GridSpec, pos: jax.Array, h: jax.Array) -> jax.Array:
    """Bin atoms into slots: returns grid_idx (cap, c_pad) int32 (atom id,
    or n for empty).  Overflow atoms beyond cap are dropped (spec.cap is
    sized with margin)."""
    n = pos.shape[0]
    c1, c2, c3 = spec.cells
    nc = jnp.asarray([c1, c2, c3])
    s = B.to_fractional(h, pos)
    s = s - jnp.floor(s)
    cxyz = jnp.clip((s * nc).astype(jnp.int32), 0, nc - 1)
    cid = (cxyz[:, 0] * c2 + cxyz[:, 1]) * c3 + cxyz[:, 2]

    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    first = jnp.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = jnp.arange(n) - first
    # overflow atoms (rank >= cap) drop via the OOB scatter — clipping
    # the rank would race slot cap-1's occupant (unspecified duplicate-
    # index order could erase an in-capacity atom)
    grid = jnp.full((spec.cap, spec.c_pad), n, dtype=jnp.int32)
    grid = grid.at[rank, cid_sorted].set(
        order.astype(jnp.int32), mode="drop"
    )
    return grid


class _GridPair:
    """Shared machinery: iterate the 27 neighbor relations yielding masked
    displacement blocks (3, cap_i, cap_j, C)."""

    def __init__(self, spec: GridSpec, pos, h, grid_idx):
        n = pos.shape[0]
        pos_pad = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)], axis=0)
        flat = grid_idx.reshape(-1)
        g = pos_pad[flat].reshape(spec.cap, spec.c_pad, 3)
        self.pos_g = jnp.transpose(g, (2, 0, 1))  # (3, cap, C)
        self.occ = (grid_idx < n)  # (cap, C)
        self.spec = spec
        self.h = h
        self.perms = [jnp.asarray(p) for p in spec.perms]
        self.ih = B.inv_h(h)

    def blocks(self):
        spec = self.spec
        zero_off = len(spec.perms) // 2 if len(spec.perms) == 27 else 0
        for o, perm in enumerate(self.perms):
            npos = jnp.take(self.pos_g, perm, axis=-1)  # (3, cap, C)
            nocc = jnp.take(self.occ, perm, axis=-1)  # (cap, C)
            dr = npos[:, None, :, :] - self.pos_g[:, :, None, :]
            ds = jnp.einsum("ab,bijc->aijc", self.ih, dr)
            ds = ds - jnp.round(ds)
            dr = jnp.einsum("ab,bijc->aijc", self.h, ds)
            r2 = jnp.sum(dr * dr, axis=0)  # (cap_i, cap_j, C)
            mask = self.occ[:, None, :] & nocc[None, :, :]
            if o == zero_off:
                cap = spec.cap
                notself = ~jnp.eye(cap, dtype=bool)[:, :, None]
                mask = mask & notself
            yield dr, r2, mask


def sw_moment_block(p, dr, r2, mask, acc):
    """One neighbor-relation block's contribution to the SW moment
    accumulators (e2, s, g^2, m, Q) — shape-agnostic over the trailing
    axes; shared by SWGrid.energy and parallel.spatial_md.

    Block axes: dr (3, i, j, ...), r2/mask (i, j, ...); accumulator
    reductions run over the j axis (axis 1 of r2 / axis 2 of dr).
    """
    e2, s_m, gsq_m, mvec, Q = acc
    rc = p.cutoff
    sig, eps = p.sigma, p.epsilon
    m = mask & (r2 < (rc - 1e-6) ** 2)
    r = jnp.sqrt(jnp.where(m, r2, 1.0))
    sr = sig / r
    srp = sr**p.p
    srq = sr**p.q
    expo = jnp.exp(sig / jnp.where(m, r - rc, -1.0))
    e2_blk = p.A * eps * (p.B * srp - srq) * expo
    e2 = e2 + 0.5 * jnp.sum(jnp.where(m, e2_blk, 0.0))

    g = jnp.where(m, jnp.exp(p.gamma * sig / jnp.where(m, r - rc, -1.0)), 0.0)
    u = dr / r[None]
    gu = g[None] * u
    s_m = s_m + jnp.sum(g, axis=1)
    gsq_m = gsq_m + jnp.sum(g * g, axis=1)
    mvec = mvec + jnp.sum(gu, axis=2)
    Q = Q + jnp.einsum("aijc,bijc->abic", gu, u)
    return e2, s_m, gsq_m, mvec, Q


def sw_three_body_from_moments(p, acc, occ):
    """e2 + e3 from accumulated moments (the quadratic-form identity)."""
    e2, s_m, gsq_m, mvec, Q = acc
    m2 = jnp.sum(mvec * mvec, axis=0)
    trq2 = jnp.einsum("abic,baic->ic", Q, Q)
    c0 = p.costheta0
    e3_atom = (trq2 - gsq_m) - 2.0 * c0 * (m2 - gsq_m) + c0 * c0 * (
        s_m * s_m - gsq_m
    )
    e3 = 0.5 * p.lam * p.epsilon * jnp.sum(jnp.where(occ, e3_atom, 0.0))
    return e2 + e3


@dataclass(frozen=True)
class SWGrid:
    """Stillinger-Weber on the cell grid (same physics as sw.SW.energy)."""

    sw: object  # forcefields.sw.SW
    spec: GridSpec

    @property
    def cutoff(self):
        return self.sw.cutoff

    def energy(self, pos: jax.Array, h: jax.Array, grid_idx: jax.Array) -> jax.Array:
        p = self.sw
        gp = _GridPair(self.spec, pos, h, grid_idx)
        cap, C = self.spec.cap, self.spec.c_pad
        dt = pos.dtype

        acc = (
            jnp.zeros((), dt),
            jnp.zeros((cap, C), dt),
            jnp.zeros((cap, C), dt),
            jnp.zeros((3, cap, C), dt),
            jnp.zeros((3, 3, cap, C), dt),
        )
        for dr, r2, mask in gp.blocks():
            acc = sw_moment_block(p, dr, r2, mask, acc)
        return sw_three_body_from_moments(p, acc, gp.occ)


@dataclass(frozen=True)
class LJGrid:
    """Single-type Lennard-Jones on the cell grid."""

    epsilon: float
    sigma: float
    cutoff: float
    spec: GridSpec

    def energy(self, pos: jax.Array, h: jax.Array, grid_idx: jax.Array) -> jax.Array:
        gp = _GridPair(self.spec, pos, h, grid_idx)
        e = jnp.zeros((), pos.dtype)
        for dr, r2, mask in gp.blocks():
            m = mask & (r2 < self.cutoff**2)
            r2s = jnp.where(m, r2, 1.0)
            s2 = self.sigma * self.sigma / r2s
            s6 = s2 * s2 * s2
            eb = 4.0 * self.epsilon * (s6 * s6 - s6)
            e = e + 0.5 * jnp.sum(jnp.where(m, eb, 0.0))
        return e
