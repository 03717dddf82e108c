"""Coulomb electrostatics: cutoff, and Ewald (real + reciprocal + self).

reference physics: ``kspace_style pppm 0.0001`` + ``pair_style
lj/cut/coul/long 12.0 9.0`` (in.set.lammps).  The on-device long-range
path starts with classical Ewald — the reciprocal sum is a dense
(n_k x N) phase matmul; the PME variant (pme.py) replaces it for large N
without changing this interface.

Real units: qqr2e = 332.06371 converts q_i q_j / r (e^2/A) to kcal/mol
(LAMMPS force.cpp real-units constant).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .. import box as B
from .. import neighbor as NB

QQR2E_REAL = 332.06371


def ewald_alpha(accuracy: float, cutoff: float) -> float:
    """LAMMPS-style splitting parameter estimate: erfc(a*rc)/rc ~ accuracy."""
    g = (1.35 - 0.15 * np.log(accuracy)) / cutoff
    return float(g)


def kvector_grid(kmax: tuple[int, int, int]) -> np.ndarray:
    """Integer reciprocal-lattice triples with the +half-space convention
    (k and -k counted once, k=0 excluded)."""
    kx, ky, kz = kmax
    out = []
    for nx in range(0, kx + 1):
        for ny in range(-ky, ky + 1):
            for nz in range(-kz, kz + 1):
                if nx == 0 and (ny < 0 or (ny == 0 and nz <= 0)):
                    continue
                out.append((nx, ny, nz))
    return np.asarray(out, dtype=np.float64)


@dataclass(frozen=True)
class Ewald:
    """Ewald summation with static k-vector set."""

    charges: jax.Array  # (N,)
    cutoff: float
    alpha: float
    kvecs: jax.Array  # (n_k, 3) integer triples
    qqr2e: float = QQR2E_REAL

    @staticmethod
    def create(charges, cutoff: float, h0, accuracy: float = 1.0e-4,
               dtype=jnp.float64) -> "Ewald":
        alpha = ewald_alpha(accuracy, cutoff)
        L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]], dtype=float)
        # kmax per dim: exp(-(pi*k/(alpha*L))^2) < accuracy
        km = np.ceil(alpha * L / np.pi * np.sqrt(-np.log(accuracy))).astype(int)
        kvecs = kvector_grid((int(km[0]), int(km[1]), int(km[2])))
        return Ewald(
            charges=jnp.asarray(charges, dtype=dtype),
            cutoff=cutoff,
            alpha=alpha,
            kvecs=jnp.asarray(kvecs, dtype=dtype),
        )

    def real_space_energy(self, pos, h, nbr: NB.NeighborList, weights=None):
        """Short-range damped part: qq erfc(alpha r)/r over the list."""
        dr = NB.neighbor_disp(pos, h, nbr)
        r2 = jnp.sum(dr * dr, axis=-1)
        mask = nbr.mask & (r2 < self.cutoff**2)
        r = jnp.sqrt(jnp.where(mask, r2, 1.0))
        qq = self.charges[:, None] * self.charges[nbr.idx]
        e = self.qqr2e * qq * jax.scipy.special.erfc(self.alpha * r) / r
        if weights is not None:
            e = e * weights
        return 0.5 * jnp.sum(jnp.where(mask, e, 0.0))

    def reciprocal_energy(self, pos, h):
        """Structure-factor sum over the static k-set (matmul-shaped)."""
        two_pi = 2.0 * jnp.pi
        hinv = B.inv_h(h)
        k_cart = two_pi * (self.kvecs @ hinv)  # (n_k, 3)
        k2 = jnp.sum(k_cart * k_cart, axis=-1)
        phase = pos @ k_cart.T  # (N, n_k)
        s_re = jnp.sum(self.charges[:, None] * jnp.cos(phase), axis=0)
        s_im = jnp.sum(self.charges[:, None] * jnp.sin(phase), axis=0)
        s2 = s_re * s_re + s_im * s_im
        V = B.volume(h)
        pref = jnp.exp(-k2 / (4.0 * self.alpha**2)) / jnp.where(k2 > 0, k2, 1.0)
        # E = (2 pi / V) sum_{all k != 0} pref |S|^2 ; the half-space k-set
        # counts each +/-k pair once, hence the factor 2
        return self.qqr2e * (2.0 * jnp.pi / V) * 2.0 * jnp.sum(pref * s2)

    def self_energy(self):
        return -self.qqr2e * self.alpha / jnp.sqrt(jnp.pi) * jnp.sum(self.charges**2)

    def excluded_correction(self, pos, h, excl_idx, excl_mask):
        """Subtract full (undamped) interactions for excluded bonded pairs.

        The reciprocal sum includes *all* pairs; excluded pairs must remove
        their full 1/r Coulomb minus what real_space already skipped:
        correction = -qq*erf(alpha r)/r per excluded pair.
        """
        if excl_idx.shape[1] == 0:
            return jnp.asarray(0.0, pos.dtype)
        dr = B.min_image_disp(h, pos[excl_idx] - pos[:, None, :])
        r2 = jnp.sum(dr * dr, axis=-1)
        r = jnp.sqrt(jnp.where(excl_mask, r2, 1.0))
        qq = self.charges[:, None] * self.charges[excl_idx]
        e = -self.qqr2e * qq * jax.scipy.special.erf(self.alpha * r) / r
        return 0.5 * jnp.sum(jnp.where(excl_mask, e, 0.0))


def coulomb_cut_energy(charges, pos, h, nbr: NB.NeighborList, cutoff: float,
                       weights=None, qqr2e: float = QQR2E_REAL):
    """Plain truncated Coulomb (coul/cut)."""
    dr = NB.neighbor_disp(pos, h, nbr)
    r2 = jnp.sum(dr * dr, axis=-1)
    mask = nbr.mask & (r2 < cutoff**2)
    r = jnp.sqrt(jnp.where(mask, r2, 1.0))
    qq = charges[:, None] * charges[nbr.idx]
    e = qqr2e * qq / r
    if weights is not None:
        e = e * weights
    return 0.5 * jnp.sum(jnp.where(mask, e, 0.0))
