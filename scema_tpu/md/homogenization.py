"""Strain-driven MD kernel + stress/stiffness homogenization.

``strain_and_homogenize`` is the on-device equivalent of one reference MD
job (STMDProblem::lammps_straining, stmd_problem.h:83-383):

1. convert the requested box-length variation into per-run strain using the
   *current* box dimensions (stmd_problem.h:221-227, the same index pattern
   as the bridging layer's length conversion);
2. pick the step count nts = ceil((|eps|/rate)/dt/10)*10, min 10
   (stmd_problem.h:228-232);
3. run NVT + fix-deform for nts steps (in.strain.lammps);
4. rerun homogenization: NVT sampling of the time-averaged virial pressure
   over nssample steps (ELASTIC/in.homogenization.lammps);
5. convert ATM -> Pa with the reference's -1.01325e5 factor
   (stmd_problem.h:335-341).

``stiffness_probe`` is the on-device ELASTIC/in.modulus.lammps: +/- finite
deformations per Voigt direction, C columns from pressure differences
(bi-displace.mod.lammps; LAMMPS Voigt order 1..6 = xx,yy,zz,yz,xz,xy is
converted to the framework order [xx,yy,zz,xy,xz,yz]).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from . import box as B
from . import engine as E
from .units import ATM_TO_PA
from ..utils import tensors as T


@dataclass(frozen=True)
class MDParams:
    """Per-run MD parameters (config 'molecular dynamics parameters')."""

    temperature: float
    dt: float  # timestep (fs in real units)
    strain_rate: float  # 1/time
    nsteps_sample: int


def effective_strain(h: jax.Array, dlength: jax.Array) -> jax.Array:
    """Per-run strain = length variation / current box dims.

    Mirrors stmd_problem.h:221-227: diagonal j divided by L_j, shear
    (j,(j+1)%3) divided by L_(j+2)%3 — i.e. Voigt [xy, xz, yz] divided by
    [lz, ly, lx] (the reference's own convention, kept for parity; see the
    bridging-layer inverse in bridge.strain_to_length_variation).
    """
    L, _ = B.lengths_tilts(h)
    div = jnp.stack([L[0], L[1], L[2], L[2], L[1], L[0]])
    return dlength / div


def nts_for_strain(eps_v: jax.Array, params: MDParams) -> jax.Array:
    """nts = ceil((|eps|/rate)/dt/10)*10, min 10 (stmd_problem.h:228-232)."""
    strain_time = T.voigt_norm(eps_v) / params.strain_rate
    nts = jnp.ceil(strain_time / params.dt / 10.0) * 10.0
    return jnp.maximum(nts, 10.0).astype(jnp.int32)


def strain_and_homogenize(
    sys: E.MDSystem,
    state: E.MDState,
    dlength: jax.Array,
    params: MDParams,
) -> tuple[E.MDState, jax.Array]:
    """One full MD job: strain the box, then sample the virial stress.

    Returns (persistent new microstate, stress in Pa, Voigt-6 framework
    order).  The returned state is the reference's ``last.<qpid>.dump``
    persistent restart — kept in device memory instead of on disk.
    """
    eps_eff = effective_strain(state.h, dlength)
    nts = nts_for_strain(eps_eff, params)
    state = E.run_strain(sys, state, eps_eff, nts, params.temperature,
                         params.dt)
    state, press = E.sample_stress(
        sys, state, params.nsteps_sample, params.temperature, params.dt
    )
    stress_pa = -press * ATM_TO_PA
    return state, stress_pa


# LAMMPS ELASTIC Voigt dir (0-based) -> framework Voigt index
# LAMMPS: 1=xx 2=yy 3=zz 4=yz 5=xz 6=xy ; framework: [xx,yy,zz,xy,xz,yz]
_LAMMPS_TO_FRAMEWORK = (0, 1, 2, 5, 4, 3)


def stiffness_probe(
    sys: E.MDSystem,
    state: E.MDState,
    params: MDParams,
    up: float = 1.0e-3,
    thermal: bool = False,
    relax_steps: int = 60,
) -> jax.Array:
    """6x6 stiffness (Pa) from +/- finite box deformations.

    ELASTIC/in.modulus.lammps semantics: for each Voigt direction apply a
    deformation of magnitude ``up`` in both signs, measure the (optionally
    time-averaged) pressure tensor, and form
    ``C[:, d] = -(P(+up) - P(-up)) / (2 up) * conv``; off-diagonal blocks
    are symmetrized afterwards (in.modulus.lammps C<ij>all averaging).

    thermal=False does cold virial evaluations after ``relax_steps`` of
    internal (fixed-box) FIRE relaxation — the relaxation captures the
    sublattice internal-displacement contribution (essential for C44 of
    diamond structures; the reference's NVT sampling relaxes thermally);
    thermal=True runs NVT sampling per probe like the reference.
    """

    def pressure_at(eps_v):
        h1 = B.deform_path(state.h, eps_v, jnp.asarray(1.0, state.pos.dtype))
        pos1 = B.remap_affine(state.h, h1, state.pos)
        st = state._replace(pos=pos1, h=h1)
        if thermal:
            _, press = E.sample_stress(
                sys, st, params.nsteps_sample, params.temperature, params.dt
            )
            return press
        if relax_steps > 0:
            st = E.minimize_fire(sys, st, n_steps=relax_steps, dt0=0.2)
        import scema_tpu.md.neighbor as NB

        nbr = sys.build_neighbors(st.pos, st.h)
        _, _, W = E.forces_energy_virial(sys, st.pos, st.h, nbr)
        return E.pressure_tensor(sys, st._replace(vel=jnp.zeros_like(st.vel)), W)

    cols = []
    for d in range(6):
        fw = _LAMMPS_TO_FRAMEWORK[d]
        eps = jnp.zeros((6,), dtype=state.pos.dtype).at[fw].set(up)
        p_plus = pressure_at(eps)
        p_minus = pressure_at(-eps)
        cols.append(-(p_plus - p_minus) / (2.0 * up) * ATM_TO_PA)
    # cols are in framework row order already (pressure_tensor is
    # [xx,yy,zz,xy,xz,yz]); build C with framework column order
    C = jnp.zeros((6, 6), dtype=state.pos.dtype)
    for d in range(6):
        C = C.at[:, _LAMMPS_TO_FRAMEWORK[d]].set(cols[d])
    return 0.5 * (C + C.T)
