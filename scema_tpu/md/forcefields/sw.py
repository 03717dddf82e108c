"""Stillinger-Weber three-body potential (single element).

reference physics: ``pair_style sw`` with Si.sw (the streched_polyhedron
example's force field, examples/.../lammps_scripts_sisw/in.set.lammps).
Functional form (Stillinger & Weber, PRB 31, 5262 (1985)):

  E = sum_{i<j} phi2(r_ij) + sum_i sum_{j<k} phi3(r_ij, r_ik, theta_jik)
  phi2(r) = A eps (B (sig/r)^p - (sig/r)^q) exp(sig / (r - a sig))
  phi3    = lam eps (cos th - cos0)^2 exp(gam sig/(r_ij - a sig))
                                      exp(gam sig/(r_ik - a sig))

both cut at r = a*sig.  The two-body sum runs over the full neighbor list
(halved); the three-body sum enumerates ordered pairs (j < k) within each
atom's own list — an (N, K, K) dense masked computation, which is the
vectorized replacement for LAMMPS's triple loop.

NOTE on units: LAMMPS interprets .sw file energies in the *active* unit
system; the shipped example runs a metal-units file under ``units real``
and the reference inherits that — parameters here are taken verbatim from
the file, same behavior.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .. import neighbor as NB


@dataclass(frozen=True)
class SW:
    epsilon: float
    sigma: float
    a: float
    lam: float
    gamma: float
    costheta0: float
    A: float
    B: float
    p: float
    q: float

    @property
    def cutoff(self) -> float:
        return self.a * self.sigma

    def energy(self, pos: jax.Array, h: jax.Array, nbr: NB.NeighborList) -> jax.Array:
        """Atom-minor layout: all hot arrays end in the atom axis N, so
        elementwise work vectorizes across atoms rather than over a
        trailing dim of 3 or K."""
        N, K = nbr.idx.shape
        posT = pos.T  # (3, N)
        # gathered neighbor coords: (3, K, N)
        nbrT = posT[:, nbr.idx.T]
        drT = nbrT - posT[:, None, :]
        # minimum image on (3, K, N)
        hinv = jnp.linalg.inv(h) if False else None
        from .. import box as BX

        ih = BX.inv_h(h)
        ds = jnp.einsum("ab,bkn->akn", ih, drT)
        ds = ds - jnp.round(ds)
        drT = jnp.einsum("ab,bkn->akn", h, ds)

        r2 = jnp.sum(drT * drT, axis=0)  # (K, N)
        rc = self.cutoff
        maskT = nbr.mask.T & (r2 < (rc - 1e-6) ** 2)
        r = jnp.sqrt(jnp.where(maskT, r2, 1.0))

        sig, eps = self.sigma, self.epsilon
        # two-body
        sr = sig / r
        srp = sr**self.p
        srq = sr**self.q
        expo = jnp.exp(sig / jnp.where(maskT, r - rc, -1.0))
        e2 = self.A * eps * (self.B * srp - srq) * expo
        e2 = 0.5 * jnp.sum(jnp.where(maskT, e2, 0.0))

        # three-body via per-atom moments: because (cos - c0)^2 is quadratic
        # in cos(theta_jik) = u_j . u_k, the double neighbor sum collapses
        # exactly to second moments of the weighted bond vectors —
        #   sum_{j!=k} g_j g_k (u_j.u_k)^2 = Tr[Q^2] - sum_j g_j^2,
        #   sum_{j!=k} g_j g_k (u_j.u_k)   = |m|^2   - sum_j g_j^2,
        #   sum_{j!=k} g_j g_k            = s^2      - sum_j g_j^2,
        # with m = sum_j g_j u_j, Q = sum_j g_j u_j u_j^T, s = sum_j g_j.
        # O(K) per atom instead of O(K^2), no (K,K,N) temporaries.
        g = jnp.exp(self.gamma * sig / jnp.where(maskT, r - rc, -1.0))
        g = jnp.where(maskT, g, 0.0)  # (K, N)
        u = drT / r[None, :, :]  # (3, K, N)
        gu = g[None, :, :] * u
        s = jnp.sum(g, axis=0)  # (N,)
        gsq = jnp.sum(g * g, axis=0)
        m2 = jnp.sum(jnp.sum(gu, axis=1) ** 2, axis=0)  # |m|^2 (N,)
        Q = jnp.einsum("akn,bkn->abn", gu, u)  # (3, 3, N)
        trq2 = jnp.einsum("abn,ban->n", Q, Q)
        c0 = self.costheta0
        e3_atom = (
            (trq2 - gsq) - 2.0 * c0 * (m2 - gsq) + c0 * c0 * (s * s - gsq)
        )
        e3 = 0.5 * self.lam * eps * jnp.sum(e3_atom)
        return e2 + e3


def read_sw_file(path: str, element: str = "Si") -> SW:
    """Parse the first matching single-element entry of a LAMMPS .sw file."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                vals.extend(line.split())
    # find "el el el" triple
    for i in range(len(vals) - 2):
        if vals[i] == element and vals[i + 1] == element and vals[i + 2] == element:
            nums = [float(x) for x in vals[i + 3 : i + 14]]
            (epsilon, sigma, a, lam, gamma, costheta0, A, B, p, q, _tol) = nums
            return SW(
                epsilon=epsilon, sigma=sigma, a=a, lam=lam, gamma=gamma,
                costheta0=costheta0, A=A, B=B, p=p, q=q,
            )
    raise ValueError(f"no {element} entry found in {path}")


# The shipped example's parameters (examples/.../lammps_scripts_sisw/Si.sw):
SI = SW(
    epsilon=2.1683, sigma=2.0951, a=1.80, lam=21.0, gamma=1.20,
    costheta0=-0.333333333333, A=7.049556277, B=0.6022245584, p=4.0, q=0.0,
)
