"""Particle-mesh Ewald (smooth PME) — the reference's ``kspace_style pppm``
on an on-device FFT mesh.

reference physics: ``kspace_style pppm 0.0001`` (lammps_scripts_opls/
in.set.lammps).  The dense Ewald reciprocal sum (coulomb.py:84-98) is
O(N * n_k) — the right tool below ~2k atoms, the wrong one above.  PME
replaces it with charge assignment onto a regular mesh via cardinal
B-splines (Essmann et al., J. Chem. Phys. 103, 8577 (1995)), one 3-D FFT
(XLA lowers jnp.fft to the backend's FFT library), a diagonal influence-
function multiply, and an inverse interpolation that autodiff derives for
free (the scatter-add's adjoint is exactly the force gather).

Drop-in for :class:`coulomb.Ewald`: same ``real_space_energy`` /
``reciprocal_energy`` / ``self_energy`` / ``excluded_correction`` surface,
so ``OPLS`` composites take either.  Interface match validated against
dense Ewald at the script's 1e-4 accuracy (tests/test_pme.py: NaCl
Madelung + random charged boxes, orthogonal and triclinic).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .. import box as B
from .coulomb import Ewald, ewald_alpha, QQR2E_REAL

SPLINE_ORDER = 5  # LAMMPS pppm default interpolation order


def bspline_m(order: int, u):
    """Cardinal B-spline M_order(u) (support (0, order)), numpy/jnp-agnostic.

    M_2(u) = 1 - |u - 1|;  M_n(u) = u/(n-1) M_{n-1}(u)
                                   + (n-u)/(n-1) M_{n-1}(u-1).
    """
    xp = jnp if isinstance(u, jax.Array) else np

    def m(n, x):
        if n == 2:
            return xp.maximum(0.0, 1.0 - xp.abs(x - 1.0))
        return (x * m(n - 1, x) + (n - x) * m(n - 1, x - 1.0)) / (n - 1.0)

    return m(order, u)


def _euler_b2(K: int, order: int) -> np.ndarray:
    """|b(m)|^2 Euler exponential-spline factors for one axis (length K).

    b(m) = exp(2 pi i (order-1) m / K) / sum_{k=0}^{order-2}
           M_order(k+1) exp(2 pi i m k / K).
    """
    m = np.arange(K)
    ks = np.arange(order - 1)
    Mk = bspline_m(order, ks + 1.0)  # (order-1,)
    denom = (Mk[None, :] * np.exp(2j * np.pi * m[:, None] * ks[None, :] / K)
             ).sum(axis=1)
    # odd order zeroes the denominator at m = K/2 (alternating M_p sum):
    # those modes are unrepresentable by the spline — DROP them (b2 = 0).
    # Clamping upward instead would amplify interpolation garbage by ~1e30
    # and corrupt the energy at the % level.
    d2 = np.abs(denom) ** 2
    b2 = np.where(d2 > 1e-10, 1.0 / np.maximum(d2, 1e-10), 0.0)
    return b2


def _next_fast(n: int) -> int:
    """Smallest 2^a * 3^b * 5^c >= n (FFT-friendly sizes)."""
    best = 1 << (int(n) - 1).bit_length()
    x = 1
    while x < 4 * n:
        y = x
        while y < 4 * n:
            z = y
            while z < n:
                z *= 2
            if n <= z < best:
                best = z
            y *= 3
        x *= 5
    return best


@dataclass(frozen=True)
class PME:
    """Smooth particle-mesh Ewald with a static FFT mesh."""

    charges: jax.Array  # (N,)
    cutoff: float
    alpha: float
    mesh: tuple  # (K1, K2, K3)
    b2x: jax.Array  # (K1,) |b|^2 factors
    b2y: jax.Array
    b2z: jax.Array
    order: int = SPLINE_ORDER
    qqr2e: float = QQR2E_REAL
    _ewald_ref: object = None  # real-space/self/exclusion provider
    # 3-D DFT as three tensor contractions with precomputed complex DFT
    # matrices instead of jnp.fft.fftn.  None = auto (fftn everywhere);
    # True opts into the matmul form (machine-precision parity,
    # tests/test_pme.py).
    dft_matmul: bool | None = None
    # rho is real, so the K3 axis of its spectrum is conjugate-
    # symmetric: rfftn computes only K3//2+1 columns and the energy sum
    # doubles the interior ones — the same value (to roundoff) at ~half
    # the DFT work.  None = ON (production default); False opts out;
    # ignored when dft_matmul is True.
    half_spectrum: bool | None = None

    @staticmethod
    def create(charges, cutoff: float, h0, accuracy: float = 1.0e-4,
               dtype=jnp.float64, mesh=None) -> "PME":
        alpha = ewald_alpha(accuracy, cutoff)
        L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]], dtype=float)
        if mesh is None:
            # cover the dense-Ewald k range with 2x headroom so the
            # B-spline interpolation error sits below the target accuracy
            km = np.ceil(alpha * L / np.pi * np.sqrt(-np.log(accuracy)))
            mesh = tuple(_next_fast(int(4 * k + 1)) for k in km)
        # real-space/self/exclusion helper only: the dense k-vector set is
        # never used (the mesh replaces it), so don't enumerate it —
        # Ewald.create's O(km^3) k-grid grows with the box and is exactly
        # the cost PME exists to avoid
        ew = Ewald(
            charges=jnp.asarray(charges, dtype=dtype),
            cutoff=cutoff,
            alpha=alpha,
            kvecs=jnp.zeros((0, 3), dtype=dtype),
        )
        return PME(
            charges=jnp.asarray(charges, dtype=dtype),
            cutoff=cutoff,
            alpha=alpha,
            mesh=mesh,
            b2x=jnp.asarray(_euler_b2(mesh[0], SPLINE_ORDER), dtype=dtype),
            b2y=jnp.asarray(_euler_b2(mesh[1], SPLINE_ORDER), dtype=dtype),
            b2z=jnp.asarray(_euler_b2(mesh[2], SPLINE_ORDER), dtype=dtype),
            _ewald_ref=ew,
        )

    # --- real-space / self / exclusion terms: identical physics to Ewald
    def real_space_energy(self, pos, h, nbr, weights=None):
        return self._ewald_ref.real_space_energy(pos, h, nbr, weights=weights)

    def self_energy(self):
        return self._ewald_ref.self_energy()

    def excluded_correction(self, pos, h, excl_idx, excl_mask):
        return self._ewald_ref.excluded_correction(pos, h, excl_idx, excl_mask)

    # --- the mesh part
    def _spread(self, pos, h):
        """B-spline charge assignment -> (K1, K2, K3) mesh.

        Scatter-free separable formulation: per-axis spread matrices
        W_a (N, K_a) are built by masked compares (5 dense select+mul
        passes, no scatter), and the 3-way outer-product accumulation
        becomes ONE matmul (K1, N) @ (N, K2*K3).  Autodiff gives the force interpolation as
        the transposed matmuls for free.
        """
        K = self.mesh
        p = self.order
        s = B.to_fractional(h, pos)
        s = s - jnp.floor(s)  # [0, 1)
        u = s * jnp.asarray(K, pos.dtype)  # (N, 3) grid coords
        fl = jnp.floor(u)
        frac = u - fl  # [0, 1)
        # weights_j = M_p(frac + j) at grid index fl - j, j = 0..p-1
        j = jnp.arange(p, dtype=pos.dtype)
        w = bspline_m(p, frac[..., None] + j)  # (N, 3, p)
        g = (fl.astype(jnp.int32)[..., None]
             - jnp.arange(p, dtype=jnp.int32))  # (N, 3, p)

        def axis_matrix(a):
            ga = (g[:, a, :] + K[a]) % K[a]  # (N, p)
            grid = jnp.arange(K[a], dtype=jnp.int32)
            hit = ga[:, :, None] == grid[None, None, :]  # (N, p, K_a)
            return jnp.sum(jnp.where(hit, w[:, a, :, None], 0.0), axis=1)

        Wx = axis_matrix(0) * self.charges[:, None]  # (N, K1)
        Wy = axis_matrix(1)
        Wz = axis_matrix(2)
        Byz = (Wy[:, :, None] * Wz[:, None, :]).reshape(
            pos.shape[0], K[1] * K[2])
        rho = Wx.T @ Byz  # (K1, K2*K3)
        return rho.reshape(K)

    def _fft3(self, rho):
        use_matmul = self.dft_matmul
        if use_matmul is None:
            use_matmul = False
        if not use_matmul:
            return jnp.fft.fftn(rho)
        # three complex tensor contractions; matrices are tiny (K, K)
        # constants
        cdtype = (jnp.complex128 if rho.dtype == jnp.float64
                  else jnp.complex64)

        def dmat(Ki):
            m = np.arange(Ki)
            return jnp.asarray(
                np.exp(-2j * np.pi * np.outer(m, m) / Ki), cdtype)

        F = jnp.einsum("ak,kbc->abc", dmat(self.mesh[0]),
                       rho.astype(cdtype))
        F = jnp.einsum("bk,akc->abc", dmat(self.mesh[1]), F)
        return jnp.einsum("ck,abk->abc", dmat(self.mesh[2]), F)

    def reciprocal_energy(self, pos, h):
        """(2 pi / V) sum_{k != 0} e^{-k^2/4a^2}/k^2 B(m) |F(rho)(m)|^2."""
        K = self.mesh
        rho = self._spread(pos, h)
        use_matmul = self.dft_matmul
        if use_matmul is None:
            use_matmul = False
        half = (self.half_spectrum is not False) and not use_matmul
        if half:
            F = jnp.fft.rfftn(rho)  # (K1, K2, K3//2 + 1)
            L3 = K[2] // 2 + 1
            mz = jnp.arange(L3, dtype=pos.dtype)
        else:
            F = self._fft3(rho)
            L3 = K[2]
            mz = jnp.fft.fftfreq(K[2], d=1.0 / K[2]).astype(pos.dtype)
        s2 = jnp.real(F) ** 2 + jnp.imag(F) ** 2

        def freqs(Ki):
            return jnp.fft.fftfreq(Ki, d=1.0 / Ki).astype(pos.dtype)

        mx, my = freqs(K[0]), freqs(K[1])
        m3 = jnp.stack(jnp.meshgrid(mx, my, mz, indexing="ij"), axis=-1)
        k_cart = 2.0 * jnp.pi * (m3 @ B.inv_h(h))  # (K1, K2, L3, 3)
        k2 = jnp.sum(k_cart * k_cart, axis=-1)
        Bm = (self.b2x[:, None, None] * self.b2y[None, :, None]
              * self.b2z[None, None, :L3])
        pref = jnp.where(
            k2 > 0, jnp.exp(-k2 / (4.0 * self.alpha**2)) / jnp.where(
                k2 > 0, k2, 1.0), 0.0)
        if half:
            # conjugate-pair doubling: interior half-spectrum columns
            # represent two full-spectrum modes; m=0 (and m=K/2 for
            # even K) are self-conjugate
            idx = jnp.arange(L3)
            if K[2] % 2 == 0:
                single = (idx == 0) | (idx == K[2] // 2)
            else:
                single = idx == 0
            pref = pref * jnp.where(single, 1.0, 2.0).astype(pos.dtype)
        V = B.volume(h)
        return self.qqr2e * (2.0 * jnp.pi / V) * jnp.sum(pref * Bm * s2)
