"""Triclinic simulation box: h-matrix algebra, minimum image, deformation.

LAMMPS box convention (the reference MD runs under it): box edge vectors
a = (lx,0,0), b = (xy,ly,0), c = (xz,yz,lz); the h-matrix is the
upper-triangular column matrix

    h = [[lx, xy, xz],
         [0,  ly, yz],
         [0,  0,  lz]]

Fractional coordinates s = h^-1 r; minimum image via s -= round(s) (valid
for cutoff < half the smallest box height — asserted at setup).

``fix deform ... remap x`` semantics (lammps_scripts in.strain.lammps:
box changed linearly in time, atom positions remapped affinely, i.e.
fractional coordinates held fixed during the box update) is
``r' = h_new h_old^-1 r``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def h_from_lengths_tilts(lengths, tilts=None) -> jax.Array:
    """(3,) lengths + optional (3,) [xy, xz, yz] -> (3,3) h-matrix."""
    lengths = jnp.asarray(lengths)
    if tilts is None:
        tilts = jnp.zeros(3, dtype=lengths.dtype)
    xy, xz, yz = tilts[0], tilts[1], tilts[2]
    z = jnp.zeros((), dtype=lengths.dtype)
    return jnp.array(
        [[lengths[0], xy, xz], [z, lengths[1], yz], [z, z, lengths[2]]]
    )


def lengths_tilts(h) -> tuple[jax.Array, jax.Array]:
    return jnp.stack([h[0, 0], h[1, 1], h[2, 2]]), jnp.stack([h[0, 1], h[0, 2], h[1, 2]])


def volume(h) -> jax.Array:
    return h[0, 0] * h[1, 1] * h[2, 2]


def inv_h(h) -> jax.Array:
    """Inverse of the box matrix.

    General (jnp.linalg.inv) rather than the upper-triangular closed form:
    the virial's strain-derivative closure (engine.forces_energy_virial)
    deforms h by arbitrary 3x3 factors, and an upper-triangular-only
    inverse silently corrupts the minimum image there — which showed up as
    an asymmetric dE/d(eps) and wrong shear virials (caught by an
    independent pair-sum virial).
    """
    return jnp.linalg.inv(h)


def to_fractional(h, pos) -> jax.Array:
    return pos @ inv_h(h).T


def to_cartesian(h, s) -> jax.Array:
    return s @ h.T


def wrap(h, pos) -> jax.Array:
    """Wrap positions into the primary cell (fractional in [0,1))."""
    s = to_fractional(h, pos)
    return to_cartesian(h, s - jnp.floor(s))


def min_image_disp(h, dr) -> jax.Array:
    """Minimum-image displacement vectors (..., 3)."""
    ds = dr @ inv_h(h).T
    ds = ds - jnp.round(ds)
    return ds @ h.T


def remap_affine(h_old, h_new, pos) -> jax.Array:
    """fix-deform 'remap x': hold fractional coords fixed under box change."""
    return pos @ (inv_h(h_old).T @ h_new.T)


def min_height(h) -> jax.Array:
    """Smallest perpendicular box height (min-image validity bound).

    For the upper-triangular h the three plane distances are
    V / |b x c|, V / |a x c|, V / |a x b|.
    """
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    V = jnp.abs(jnp.dot(a, jnp.cross(b, c)))
    d0 = V / jnp.linalg.norm(jnp.cross(b, c))
    d1 = V / jnp.linalg.norm(jnp.cross(a, c))
    d2 = V / jnp.linalg.norm(jnp.cross(a, b))
    return jnp.minimum(d0, jnp.minimum(d1, d2))


def deform_path(h0: jax.Array, eps_eff: jax.Array, frac: jax.Array) -> jax.Array:
    """Box at fraction ``frac`` of a fix-deform run toward strain eps_eff.

    ``eps_eff`` is the Voigt-6 engineering strain relative to the *current*
    box (the reference converts length variations to per-run strains this
    way, stmd_problem.h:221-244): diagonals scale lengths
    ``L_i(f) = L_i0 (1 + f eps_ii)``; shear components change tilts by
    ``f * eps_ij * L_assoc0`` with the LAMMPS-associated lengths
    (xy->ly, xz->lz, yz->lz).
    """
    L0, t0 = lengths_tilts(h0)
    L = L0 * (1.0 + frac * eps_eps_diag(eps_eff))
    assoc = jnp.stack([L0[1], L0[2], L0[2]])
    tilts = t0 + frac * eps_shear(eps_eff) * assoc
    return h_from_lengths_tilts(L, tilts)


def eps_eps_diag(eps_v):
    return eps_v[..., :3]


def eps_shear(eps_v):
    return eps_v[..., 3:]
