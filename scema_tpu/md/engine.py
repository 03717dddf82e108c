"""The batched on-device MD engine: velocity Verlet + Nose-Hoover chains,
fix-deform strain driving, virial pressure sampling.

This replaces the LAMMPS instances the reference spawns per quadrature
point (stmd_problem.h:83-383): instance #1 = ``run_strain`` (NVT with
``fix deform ... erate`` box deformation, in.strain.lammps), instance #2 =
``sample_stress`` (NVT with time-averaged virial pressure,
ELASTIC/in.homogenization.lammps).  All functions are pure and vmap/jit
friendly; the bridging layer vmaps them over (jobs x replicas).

Forces and the potential virial come from automatic differentiation of the
force field's energy — one backward pass yields both (the strain-derivative
definition of the virial is exact for any functional form, including SW
three-body terms).

Thermostat: Nose-Hoover chain (M=3, MTK), the on-device equivalent of
``fix nvt temp T T 100.0`` (in.strain.lammps) with Tdamp in time units.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import box as B
from . import neighbor as NB
from .units import UnitSystem, REAL

NHC_LEN = 3  # thermostat chain length (LAMMPS default tchain=3)


class MDState(NamedTuple):
    pos: jax.Array  # (N, 3)
    vel: jax.Array  # (N, 3)
    h: jax.Array  # (3, 3) upper-triangular box
    vxi: jax.Array  # (NHC_LEN,) thermostat velocities


@dataclass(frozen=True)
class MDSystem:
    """Static MD configuration (shapes + force field + units)."""

    ff: object  # force field with .energy(pos, h, nbr)
    masses: jax.Array  # (N,) atomic masses
    nspec: NB.NeighborSpec
    units: UnitSystem = REAL
    rebuild_every: int = 10  # neighbor-list reuse (neigh_modify analog)
    tdamp: float = 100.0  # thermostat damping, time units (fix nvt ... 100.0)
    grid: object = None  # grid.GridSpec — use the gather-free cell grid
    onehot: object = None  # neighbor_onehot.OneHotSpec — one-hot gather
    constraints: object = None  # constraints.Constraints — SHAKE/RATTLE
    spatial: object = None  # spatial_md.SpatialRunner — P4 slab-sharded
    # force evaluations inside the run_strain/sample_stress loops

    @property
    def n_atoms(self) -> int:
        return int(self.masses.shape[0])

    @property
    def ndof(self) -> int:
        # LAMMPS fix shake subtracts each rigid bond from the temperature
        # DOF count; without this the NHC thermostat targets an inflated KE
        # and overheats constrained systems.
        n_cons = 0
        if self.constraints is not None:
            import numpy as np

            # mask is concrete (constraints are built eagerly at setup)
            n_cons = int(np.asarray(self.constraints.mask).sum())
        return 3 * self.n_atoms - 3 - n_cons

    def build_neighbors(self, pos, h):
        """Interaction structure for ff.energy: grid, one-hot, or list.

        Force fields that need no per-run neighbor data (the dense ReaxFF
        field declares ``slot_ids``) get a placeholder carried through the
        loops instead.
        """
        if getattr(self.ff, "slot_ids", None) is not None:
            return jnp.zeros((), dtype=jnp.int32)
        if self.grid is not None:
            from . import grid as G

            return G.build_grid(self.grid, pos, h)
        if self.onehot is not None:
            from . import neighbor_onehot as OH

            return OH.build_onehot(self.onehot, pos, h)
        return NB.build(self.nspec, pos, h)


def init_state(pos, h, vel=None, dtype=None) -> MDState:
    pos = jnp.asarray(pos, dtype=dtype)
    if vel is None:
        vel = jnp.zeros_like(pos)
    return MDState(
        pos=pos, vel=jnp.asarray(vel, dtype=pos.dtype), h=jnp.asarray(h, dtype=pos.dtype),
        vxi=jnp.zeros((NHC_LEN,), dtype=pos.dtype),
    )


def maxwell_velocities(sys: MDSystem, key, T: float, dtype=jnp.float64) -> jax.Array:
    """Maxwell-Boltzmann velocities at T with zero center-of-mass momentum."""
    n = sys.n_atoms
    std = jnp.sqrt(sys.units.boltz * T * sys.units.ftm2v / sys.masses)[:, None]
    v = jax.random.normal(key, (n, 3), dtype=dtype) * std
    m = sys.masses[:, None]
    v = v - jnp.sum(m * v, axis=0) / jnp.sum(m)
    # rescale to exact target temperature
    ke2 = jnp.sum(m * v * v) / sys.units.ftm2v
    t_now = ke2 / (sys.ndof * sys.units.boltz)
    return v * jnp.sqrt(T / jnp.maximum(t_now, 1e-30))


def temperature(sys: MDSystem, vel) -> jax.Array:
    ke2 = jnp.sum(sys.masses[:, None] * vel * vel) / sys.units.ftm2v
    return ke2 / (sys.ndof * sys.units.boltz)


def forces(sys: MDSystem, pos, h, nbr) -> jax.Array:
    return -jax.grad(lambda p: sys.ff.energy(p, h, nbr))(pos)


def forces_energy_virial(sys: MDSystem, pos, h, nbr):
    """(F, E, W): forces, potential energy, potential virial tensor.

    W_ab = -dE/d eps_ab for the affine deformation pos->(1+eps)pos,
    h->(1+eps)h — one extra gradient alongside the force gradient.
    """

    def e(p, eps):
        F = jnp.eye(3, dtype=p.dtype) + eps
        return sys.ff.energy(p @ F.T, F @ h, nbr)

    eps0 = jnp.zeros((3, 3), dtype=pos.dtype)
    E, (gp, geps) = jax.value_and_grad(e, argnums=(0, 1))(pos, eps0)
    W = -0.5 * (geps + geps.T)
    return -gp, E, W


def _qeq_warm_enabled(sys: MDSystem) -> bool:
    """True when the force field supports CG warm-starting between the
    steps of a neighbor-rebuild chunk (ReaxFFList.qeq_warm — the fix
    qeq/reax pattern: one cold solve per chunk, few-iteration seeded
    solves for the chunk's remaining steps)."""
    ff = sys.ff
    return bool(getattr(ff, "qeq_warm", False) and getattr(ff, "qeq", False)
                and hasattr(ff, "energy_qeq"))


def _forces_qeq(sys: MDSystem, pos, h, nbr, guess):
    """(F, qeq_aux): forces with the QEq CG seeded by ``guess``."""
    (_, aux), g = jax.value_and_grad(
        lambda p: sys.ff.energy_qeq(p, h, nbr, qeq_guess=guess),
        has_aux=True)(pos)
    return -g, aux


def _forces_virial_qeq(sys: MDSystem, pos, h, nbr, guess):
    """(F, W, qeq_aux) from ONE energy evaluation (sampling loop)."""

    def e(p, eps):
        Fm = jnp.eye(3, dtype=p.dtype) + eps
        return sys.ff.energy_qeq(p @ Fm.T, Fm @ h, nbr, qeq_guess=guess)

    eps0 = jnp.zeros((3, 3), dtype=pos.dtype)
    (_, aux), (gp, geps) = jax.value_and_grad(
        e, argnums=(0, 1), has_aux=True)(pos, eps0)
    W = -0.5 * (geps + geps.T)
    return -gp, W, aux


def pressure_tensor(sys: MDSystem, state: MDState, W) -> jax.Array:
    """Instantaneous virial pressure tensor in pressure units (Voigt-6).

    LAMMPS compute pressure: P = (sum m v x v * mvv2e + W) / V * nktv2p.
    """
    m = sys.masses[:, None]
    kin = jnp.einsum("na,nb->ab", m * state.vel, state.vel) / sys.units.ftm2v
    P = (kin + W) / B.volume(state.h) * sys.units.nktv2p
    return jnp.stack([P[0, 0], P[1, 1], P[2, 2], P[0, 1], P[0, 2], P[1, 2]])


def _nhc_half(sys: MDSystem, vel, vxi, T: float, dt: float):
    """Half-step Nose-Hoover chain update (MTK); returns scaled (vel, vxi)."""
    u = sys.units
    kt = u.boltz * T
    ndof = sys.ndof
    q = jnp.concatenate(
        [jnp.asarray([ndof * kt * sys.tdamp**2], dtype=vel.dtype),
         jnp.full((NHC_LEN - 1,), kt * sys.tdamp**2, dtype=vel.dtype)]
    )
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0

    ke2 = jnp.sum(sys.masses[:, None] * vel * vel) / u.ftm2v  # 2*KE

    def g(k, ke2_):
        return jnp.where(
            k == 0,
            (ke2_ - ndof * kt) / q[0],
            (q[k - 1] * vxi_ref[k - 1] ** 2 - kt) / q[k],
        )

    # update chain tail -> head
    vxi_ref = vxi
    for k in range(NHC_LEN - 1, -1, -1):
        if k == NHC_LEN - 1:
            vxi_ref = vxi_ref.at[k].add(dt4 * g(k, ke2))
        else:
            s = jnp.exp(-dt8 * vxi_ref[k + 1])
            vxi_ref = vxi_ref.at[k].set(s * (s * vxi_ref[k] + dt4 * g(k, ke2)))

    # scale particle velocities
    scale = jnp.exp(-dt2 * vxi_ref[0])
    vel = vel * scale
    ke2 = ke2 * scale * scale

    # update chain head -> tail
    for k in range(NHC_LEN):
        if k == NHC_LEN - 1:
            vxi_ref = vxi_ref.at[k].add(dt4 * g(k, ke2))
        else:
            s = jnp.exp(-dt8 * vxi_ref[k + 1])
            vxi_ref = vxi_ref.at[k].set(s * (s * vxi_ref[k] + dt4 * g(k, ke2)))
    return vel, vxi_ref


def _verlet_step(sys: MDSystem, state: MDState, F, nbr, T, dt,
                 thermostat=True, forces_fn=None, forces_ex_fn=None):
    """One velocity-Verlet step (optionally NVT); returns (state, F_new).

    With sys.constraints set, SHAKE corrects positions after the drift and
    RATTLE removes along-bond velocity components after the second kick
    (the reference's fix shake, in.strain.lammps).  ``forces_fn(pos, h)``
    overrides the force evaluation (the P4 sharded path plugs in here).
    ``forces_ex_fn(pos, h) -> (F, extra)`` does the same but threads an
    extra value out alongside the forces — the sampling loop shares one
    energy evaluation between forces and virial this way, and the QEq
    warm-start carries its CG vectors; the return becomes
    ``(state, F_new, extra)``.
    """
    u = sys.units
    minv = (u.ftm2v / sys.masses)[:, None]
    vel, vxi = state.vel, state.vxi
    if thermostat:
        vel, vxi = _nhc_half(sys, vel, vxi, T, dt)
    vel = vel + 0.5 * dt * F * minv
    pos = state.pos + dt * vel
    if sys.constraints is not None:
        from . import constraints as CN

        inv_m = 1.0 / sys.masses
        pos_c = CN.shake_positions(sys.constraints, state.pos, pos, state.h, inv_m)
        vel = vel + (pos_c - pos) / dt  # constraint impulse on velocities
        pos = pos_c
    extra = None
    if forces_ex_fn is not None:
        F_new, extra = forces_ex_fn(pos, state.h)
    elif forces_fn is None:
        F_new = forces(sys, pos, state.h, nbr)
    else:
        F_new = forces_fn(pos, state.h)
    vel = vel + 0.5 * dt * F_new * minv
    if sys.constraints is not None:
        vel = CN.rattle_velocities(sys.constraints, pos, vel, state.h, 1.0 / sys.masses)
    if thermostat:
        vel, vxi = _nhc_half(sys, vel, vxi, T, dt)
    out = state._replace(pos=pos, vel=vel, vxi=vxi)
    if forces_ex_fn is not None:
        return out, F_new, extra
    return out, F_new


def run_strain(
    sys: MDSystem,
    state: MDState,
    eps_eff: jax.Array,
    n_steps: jax.Array,
    T: float,
    dt: float,
) -> MDState:
    """NVT run with linear box deformation toward strain ``eps_eff``.

    The on-device ``in.strain.lammps``: ``fix deform ... erate`` on all six
    components with affine remap + ``fix nvt``.  ``n_steps`` may be traced
    (per-job, nts = ceil(|eps|/rate/dt/10)*10, stmd_problem.h:228-232) but
    is always a multiple of rebuild_every=10, so the loop runs in chunks of
    10 with one neighbor rebuild per chunk.
    """
    if sys.spatial is not None:
        from ..parallel import spatial_md as SP

        return SP.run_strain_sharded(sys, sys.spatial, state, eps_eff,
                                     n_steps, T, dt)
    h0 = state.h
    n_steps = jnp.maximum(n_steps, sys.rebuild_every)
    n_chunks = n_steps // sys.rebuild_every
    warm = _qeq_warm_enabled(sys)

    def chunk(c, st):
        nbr = sys.build_neighbors(st.pos, st.h)
        if warm:
            F, aux = _forces_qeq(sys, st.pos, st.h, nbr, None)  # cold solve
        else:
            F = forces(sys, st.pos, st.h, nbr)

        def deform(st, i):
            # fix deform end_of_step: move box to its target at global step+1
            gstep = c * sys.rebuild_every + i + 1
            frac = gstep.astype(st.pos.dtype) / n_steps.astype(st.pos.dtype)
            h_new = B.deform_path(h0, eps_eff, frac)
            pos = B.remap_affine(st.h, h_new, st.pos)
            return st._replace(pos=pos, h=h_new)

        if warm:
            def inner(i, carry):
                st, F, aux = carry
                st, F, aux = _verlet_step(
                    sys, st, F, nbr, T, dt,
                    forces_ex_fn=lambda pos, h: _forces_qeq(
                        sys, pos, h, nbr, aux))
                return (deform(st, i), F, aux)

            st, _, _ = jax.lax.fori_loop(
                0, sys.rebuild_every, inner, (st, F, aux))
        else:
            def inner(i, carry):
                st, F = carry
                st, F = _verlet_step(sys, st, F, nbr, T, dt)
                return (deform(st, i), F)

            st, _ = jax.lax.fori_loop(0, sys.rebuild_every, inner, (st, F))
        return st

    return jax.lax.fori_loop(0, n_chunks, chunk, state)


def run_nvt(sys: MDSystem, state: MDState, n_steps: int, T: float, dt: float) -> MDState:
    """Plain NVT run (static step count)."""
    zero = jnp.zeros((6,), dtype=state.pos.dtype)
    return run_strain(sys, state, zero, jnp.asarray(n_steps), T, dt)


def run_npt(
    sys: MDSystem,
    state: MDState,
    n_steps: int,
    T_start: float,
    T_end: float,
    dt: float,
    p_target: float = 1.0,
    pdamp: float = 1000.0,
    compressibility: float = 4.5e-5,
    barostat: str = "mtk",
) -> MDState:
    """NPT with a temperature ramp — the reference's material-prep stages
    (``fix npt temp T1 T2 100.0 iso 1.0 1.0 1000``, in.init.lammps;
    driven from init_material_problem.h:114-303).

    ``barostat="mtk"`` (production default) is the Martyna-Tobias-Klein
    isotropic barostat that ``fix npt`` itself integrates — a barostat
    momentum with its own Nose-Hoover chain and the MTK velocity/box
    coupling terms, so box volume SAMPLES the NPT ensemble.
    ``barostat="berendsen"`` keeps the round-2 weak-coupling relaxer
    (monotone approach, no volume fluctuations) as a fallback;
    ``compressibility`` only applies to it.
    """
    if barostat == "mtk":
        return _run_npt_mtk(sys, state, n_steps, T_start, T_end, dt,
                            p_target, pdamp)
    n_chunks = max(1, n_steps // sys.rebuild_every)
    total = n_chunks * sys.rebuild_every

    def chunk(c, st):
        nbr = sys.build_neighbors(st.pos, st.h)
        F = forces(sys, st.pos, st.h, nbr)

        def inner(i, carry):
            st, F = carry
            gstep = c * sys.rebuild_every + i
            frac = gstep.astype(st.pos.dtype) / total
            T = T_start + (T_end - T_start) * frac
            st, F = _verlet_step(sys, st, F, nbr, T, dt)
            _, _, W = forces_energy_virial(sys, st.pos, st.h, nbr)
            p6 = pressure_tensor(sys, st, W)
            p_iso = (p6[0] + p6[1] + p6[2]) / 3.0
            # clamp the base before the cube root (LAMMPS-style mu limiting):
            # a large transient virial on an unequilibrated structure can
            # drive the base negative, which would NaN the whole state
            mu_base = jnp.clip(
                1.0 - dt / pdamp * compressibility * (p_target - p_iso), 0.9, 1.1
            )
            mu = mu_base ** (1.0 / 3.0)
            h_new = st.h * mu
            pos = st.pos * mu
            return (st._replace(pos=pos, h=h_new), F)

        st, _ = jax.lax.fori_loop(0, sys.rebuild_every, inner, (st, F))
        return st

    return jax.lax.fori_loop(0, n_chunks, chunk, state)


def _baro_nhc_half(vxi_b, omega_dot, W_b, kt, pdamp, dt, dtype):
    """Half-step Nose-Hoover chain on the barostat momentum (LAMMPS
    fix_nh::nhc_press_integrate): one translational dof (the isotropic
    epsilon), chain masses Q = kT pdamp^2."""
    q = jnp.full((NHC_LEN,), kt * pdamp * pdamp, dtype=dtype)
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0
    ke2 = W_b * omega_dot * omega_dot

    def g(k, ke2_, vref):
        return jnp.where(
            k == 0,
            (ke2_ - kt) / q[0],
            (q[k - 1] * vref[k - 1] ** 2 - kt) / q[k],
        )

    for k in range(NHC_LEN - 1, -1, -1):
        if k == NHC_LEN - 1:
            vxi_b = vxi_b.at[k].add(dt4 * g(k, ke2, vxi_b))
        else:
            s = jnp.exp(-dt8 * vxi_b[k + 1])
            vxi_b = vxi_b.at[k].set(s * (s * vxi_b[k] + dt4 * g(k, ke2, vxi_b)))
    scale = jnp.exp(-dt2 * vxi_b[0])
    omega_dot = omega_dot * scale
    ke2 = ke2 * scale * scale
    for k in range(NHC_LEN):
        if k == NHC_LEN - 1:
            vxi_b = vxi_b.at[k].add(dt4 * g(k, ke2, vxi_b))
        else:
            s = jnp.exp(-dt8 * vxi_b[k + 1])
            vxi_b = vxi_b.at[k].set(s * (s * vxi_b[k] + dt4 * g(k, ke2, vxi_b)))
    return vxi_b, omega_dot


def _run_npt_mtk(sys, state, n_steps, T_start, T_end, dt, p_target, pdamp):
    """Isotropic MTK NPT (LAMMPS fix_nh's integration order, iso case).

    Per step, with the barostat strain rate ``omega_dot`` (epsilon-dot)
    and its chain ``vxi_b`` carried alongside the particle state:

      chains(dt/2) -> omega_dot(dt/2) -> v-MTK-scale(dt/2) -> kick(dt/2)
      -> dilated drift (x, h x= exp(dt/2 w) around the dt v-drift)
      -> forces -> kick(dt/2) -> v-MTK-scale(dt/2) -> omega_dot(dt/2)
      -> chains(dt/2)

    with f_omega = (3 V (P - P0)/nktv2p + 2KE/N) / W_b (the 2KE/N being
    the MTK correction, pdim=3 folded into the single epsilon dof),
    W_b = 3 (N + 1) kT pdamp^2 (LAMMPS omega_mass summed over the three
    coupled directions) and the velocity scale
    exp(-dt/2 (1 + 1/N) omega_dot) (mtk_term2).  The instantaneous
    virial pressure comes from forces_energy_virial each half-step's
    force evaluation (one extra h-gradient, same cost class as the
    Berendsen path's per-step virial).
    """
    u = sys.units
    dtype = state.pos.dtype
    n_chunks = max(1, n_steps // sys.rebuild_every)
    total = n_chunks * sys.rebuild_every
    N = float(sys.n_atoms)
    minv = (u.ftm2v / sys.masses)[:, None]
    dt2 = dt / 2.0

    def p_iso_of(st, W):
        p6 = pressure_tensor(sys, st, W)
        return (p6[0] + p6[1] + p6[2]) / 3.0

    def f_omega(st, p_iso, kt_t):
        ke2 = jnp.sum(sys.masses[:, None] * st.vel * st.vel) / u.ftm2v
        vol = B.volume(st.h)
        w_b = 3.0 * (N + 1.0) * kt_t * pdamp * pdamp
        return ((p_iso - p_target) * 3.0 * vol / u.nktv2p + ke2 / N) / w_b

    def chunk(c, carry):
        st, omega_dot, vxi_b = carry
        nbr = sys.build_neighbors(st.pos, st.h)
        _, _, W = forces_energy_virial(sys, st.pos, st.h, nbr)
        F = forces(sys, st.pos, st.h, nbr)

        def inner(i, carry_i):
            st, F, W, omega_dot, vxi_b = carry_i
            gstep = c * sys.rebuild_every + i
            frac = gstep.astype(dtype) / total
            T = T_start + (T_end - T_start) * frac
            kt_t = u.boltz * T
            w_b = 3.0 * (N + 1.0) * kt_t * pdamp * pdamp

            # chains + omega_dot + MTK velocity scale (first half)
            vel, vxi = _nhc_half(sys, st.vel, st.vxi, T, dt)
            vxi_b, omega_dot = _baro_nhc_half(
                vxi_b, omega_dot, w_b, kt_t, pdamp, dt, dtype)
            st_v = st._replace(vel=vel)
            omega_dot = omega_dot + dt2 * f_omega(st_v, p_iso_of(st_v, W),
                                                  kt_t)
            mtk_scale = jnp.exp(-dt2 * (1.0 + 1.0 / N) * omega_dot)
            vel = vel * mtk_scale

            # kick + dilated drift
            vel = vel + dt2 * F * minv
            e1 = jnp.exp(dt2 * omega_dot)
            pos = (st.pos * e1 + dt * vel) * e1
            h_new = st.h * (e1 * e1)
            if sys.constraints is not None:
                from . import constraints as CN

                inv_m = 1.0 / sys.masses
                pos_c = CN.shake_positions(
                    sys.constraints, st.pos * e1 * e1, pos, h_new, inv_m)
                vel = vel + (pos_c - pos) / dt
                pos = pos_c
            st = st._replace(pos=pos, h=h_new)

            F_new, _, W_new = forces_energy_virial(sys, pos, h_new, nbr)
            vel = vel + dt2 * F_new * minv
            if sys.constraints is not None:
                vel = CN.rattle_velocities(
                    sys.constraints, pos, vel, h_new, 1.0 / sys.masses)

            # second half: MTK scale + omega_dot + chains
            vel = vel * mtk_scale
            st_v = st._replace(vel=vel)
            omega_dot = omega_dot + dt2 * f_omega(
                st_v, p_iso_of(st_v, W_new), kt_t)
            vxi_b, omega_dot = _baro_nhc_half(
                vxi_b, omega_dot, w_b, kt_t, pdamp, dt, dtype)
            vel, vxi = _nhc_half(sys, vel, vxi, T, dt)
            return (st._replace(vel=vel, vxi=vxi), F_new, W_new,
                    omega_dot, vxi_b)

        st, _, _, omega_dot, vxi_b = jax.lax.fori_loop(
            0, sys.rebuild_every, inner, (st, F, W, omega_dot, vxi_b))
        return st, omega_dot, vxi_b

    zero = jnp.zeros((), dtype)
    st, _, _ = jax.lax.fori_loop(
        0, n_chunks, chunk,
        (state, zero, jnp.zeros((NHC_LEN,), dtype)))
    return st


def sample_stress(
    sys: MDSystem, state: MDState, n_steps: int, T: float, dt: float
) -> tuple[MDState, jax.Array]:
    """NVT run returning the time-averaged virial pressure (Voigt-6).

    The on-device ELASTIC/in.homogenization.lammps: ``fix ave/time ...
    c_thermo_press ave running`` over nssample steps; the reference then
    converts to Pa as ``-p * 1.01325e5`` (stmd_problem.h:335-341) — the
    conversion is left to the caller (homogenization.py).
    """
    if sys.spatial is not None:
        from ..parallel import spatial_md as SP

        return SP.sample_stress_sharded(sys, sys.spatial, state, n_steps,
                                        T, dt)
    n_chunks = max(1, n_steps // sys.rebuild_every)
    warm = _qeq_warm_enabled(sys)

    def chunk(st, _):
        nbr = sys.build_neighbors(st.pos, st.h)
        acc0 = jnp.zeros((6,), dtype=st.pos.dtype)
        if warm:
            F, _, aux = _forces_virial_qeq(sys, st.pos, st.h, nbr, None)

            def inner(i, carry):
                st, F, aux, acc = carry

                def fex(pos, h, aux=aux):
                    Fx, Wx, ax = _forces_virial_qeq(sys, pos, h, nbr, aux)
                    return Fx, (Wx, ax)

                st, F, (W, aux) = _verlet_step(
                    sys, st, F, nbr, T, dt, forces_ex_fn=fex)
                return (st, F, aux, acc + pressure_tensor(sys, st, W))

            st, _, _, acc = jax.lax.fori_loop(
                0, sys.rebuild_every, inner, (st, F, aux, acc0))
        else:
            F = forces(sys, st.pos, st.h, nbr)

            def fex(pos, h):
                # one energy evaluation serves forces AND virial (the
                # historical form re-ran forces_energy_virial after the
                # step at the same positions — a 2x energy cost)
                Fx, _, Wx = forces_energy_virial(sys, pos, h, nbr)
                return Fx, Wx

            def inner(i, carry):
                st, F, acc = carry
                st, F, W = _verlet_step(
                    sys, st, F, nbr, T, dt, forces_ex_fn=fex)
                return (st, F, acc + pressure_tensor(sys, st, W))

            st, _, acc = jax.lax.fori_loop(
                0, sys.rebuild_every, inner, (st, F, acc0))
        return st, acc

    state, accs = jax.lax.scan(chunk, state, None, length=n_chunks)
    press = jnp.sum(accs, axis=0) / (n_chunks * sys.rebuild_every)
    return state, press


def minimize_fire(
    sys: MDSystem, state: MDState, n_steps: int = 200,
    dt0: float = 1.0, fmax_dt: float = 4.0,
) -> MDState:
    """FIRE relaxation (the reference's ``min_style sd``/minimize analog in
    in.init.lammps material prep).  Fixed iteration count, static shapes.
    """
    u = sys.units

    def chunk(st_dt_v, _):
        st, dt, alpha = st_dt_v
        nbr = sys.build_neighbors(st.pos, st.h)

        def inner(i, carry):
            st, dt, alpha, vel = carry
            F = forces(sys, st.pos, st.h, nbr)
            minv = (u.ftm2v / sys.masses)[:, None]
            vel = vel + dt * F * minv
            fnorm = jnp.sqrt(jnp.sum(F * F)) + 1e-30
            vnorm = jnp.sqrt(jnp.sum(vel * vel))
            power = jnp.sum(F * vel)
            vel = (1 - alpha) * vel + alpha * vnorm * F / fnorm
            uphill = power < 0.0
            vel = jnp.where(uphill, jnp.zeros_like(vel), vel)
            dt = jnp.where(uphill, dt * 0.5, jnp.minimum(dt * 1.1, fmax_dt))
            alpha = jnp.where(uphill, jnp.asarray(0.1, dt.dtype), alpha * 0.99)
            # per-step displacement cap (LAMMPS dmax analog): keeps steep
            # unequilibrated contacts from launching atoms in float32
            step_d = dt * vel
            dmax = 0.1
            dn = jnp.sqrt(jnp.sum(step_d * step_d, axis=-1, keepdims=True))
            step_d = step_d * jnp.minimum(1.0, dmax / jnp.maximum(dn, 1e-30))
            pos = st.pos + step_d
            return (st._replace(pos=pos), dt, alpha, vel)

        st, dt, alpha, _ = jax.lax.fori_loop(
            0, sys.rebuild_every, inner, (st, dt, alpha, jnp.zeros_like(st.pos))
        )
        return (st, dt, alpha), None

    n_chunks = max(1, n_steps // sys.rebuild_every)
    (state, _, _), _ = jax.lax.scan(
        chunk,
        (state, jnp.asarray(dt0, state.pos.dtype), jnp.asarray(0.1, state.pos.dtype)),
        None,
        length=n_chunks,
    )
    return state._replace(vel=jnp.zeros_like(state.vel))
