"""Material initialization: build + equilibrate a replica, measure its
equilibrium length/stress/stiffness/density.

The on-device ``init_material`` executable (init_material.cc,
init_material_problem.h:114-303): the reference minimizes, runs a staged
heatup/cooldown NPT/NVT cycle (in.init.lammps), measures box lengths,
samples the residual stress (ELASTIC homogenization), and probes the 6x6
Voigt stiffness with +/- finite-difference deformations (in.modulus), then
writes init.<mat>_<n>.{length,stress,stiff,bin}.  Here the same pipeline
runs on device and returns arrays; io helpers write the reference-format
text files for interop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import box as B
from . import engine as E
from . import lattice
from . import neighbor as NB
from .forcefields import lj as LJmod
from .forcefields import sw as SWmod
from .homogenization import MDParams, stiffness_probe
from .units import REAL, ATM_TO_PA, UnitSystem

# g/mol per A^3 -> kg/m^3
DENSITY_CONV = 1660.539


@dataclass(frozen=True)
class MaterialSpec:
    """Description of one MD material box (replaces nanoscale_input files)."""

    name: str
    force_field: str = "sw"  # sw | lj | opls
    n_cells: int = 3  # lattice cells per dimension
    # non-cubic cell counts (overrides n_cells); used when seeding the
    # box geometry from a reference LAMMPS binary restart whose lattice
    # is not cubic (init.sic_1.bin is 2x3x4 cells)
    n_cells_xyz: tuple | None = None
    a0: float = 5.431  # lattice parameter (A)
    mass: float = 28.0855  # g/mol
    sw: SWmod.SW = field(default_factory=lambda: SWmod.SI)
    lj_epsilon: float = 0.238
    lj_sigma: float = 3.405
    lj_cutoff: float = 8.0
    # neighbor-list width override; None = per-force-field default
    # (sw 20, lj/opls density-derived).  An explicit value is honored
    # as given — it is NOT clamped down (a user raising it after a
    # width warning must actually get the wider list).
    neighbor_k: int | None = None
    rebuild_every: int = 10
    # opls extras: a LAMMPS data file, or the built-in alkane-melt builder
    data_file: str = ""
    # 64 chains x 8 beads => L ~ 25.8 A at 0.7 g/cm^3, satisfying the
    # minimum-image bound for the 10 A cutoff + skin (the old 27-chain
    # melt's 19.3 A box was smaller than 2x cutoff)
    n_chains: int = 64
    chain_length: int = 8
    opls_lj_cutoff: float = 10.0
    opls_coul_cutoff: float = 9.0  # real-space Coulomb cutoff (in.set.lammps)
    use_ewald: bool = False  # alkanes are uncharged; data files may enable
    # all-atom PE melt (data_io.build_pe_melt_allatom): the reference's
    # actual OPLS material class — charged, H-bearing (in.set.lammps:
    # lj/cut/coul/long + pppm, in.strain.lammps: fix shake m 1.0)
    allatom: bool = False
    pe_density: float = 0.70
    # SHAKE on bonds involving mass-1 atoms; None = auto (on for allatom)
    shake: bool | None = None
    # reciprocal-sum backend: 'auto' (dense Ewald below 2048 atoms, PME
    # above — data_io.to_opls), 'ewald', or 'pme'
    kspace: str = "auto"
    # P4 spatial decomposition: shard ONE big SW box's force work into
    # x-slabs over this many devices (the reference's per-job LAMMPS
    # domain decomposition, stmd_problem.h:156,284); 0 = off
    spatial_shards: int = 0
    # setup-time sanity checks (min-image bound, k_max coverage, cell
    # capacity); disable only for deliberately unphysical test fixtures
    validate: bool = True
    # reax extras (force_field="reax"): ffield.reax path, pair_coeff
    # element order (in.set.lammps: `pair_coeff * * ${locf} H C N O`),
    # charge equilibration on/off, bonded-neighbor gather width
    reax_ffield: str = ""
    reax_elements: tuple = ("H", "C", "N", "O")
    qeq: bool = True
    reax_top_k: int = 8
    # "list" = production neighbor-list bond-order field (O(N K), no box
    # cap); "dense" = the O(N^2) reference twin kept as parity anchor
    reax_impl: str = "list"


@dataclass(frozen=True)
class InitData:
    """The reference's per-replica equilibration outputs
    (init.<mat>_<n>.{length,stress,stiff} + density)."""

    length: np.ndarray  # (3,)
    stress: np.ndarray  # (6,) Pa
    stiff: np.ndarray  # (6, 6) Pa
    density: float  # kg/m^3


def _validate_setup(spec: MaterialSpec, pos, h, nspec: NB.NeighborSpec) -> None:
    """Setup-time sanity checks (eager numpy; reference: LAMMPS errors out
    on 'cutoff > half the box' and neighbor-page overflow — here the
    static-shape analogs are checked once at system build).

    1. Minimum-image bound: r_list <= min_height(h)/2 — beyond it the
       single-image neighbor search misses genuine periodic copies.
    2. List width: k_max must hold every neighbor within cutoff + skin/2
       (allowing motion during the rebuild interval).
    3. Cell capacity: the fullest cell must fit the slot grid, else atoms
       silently free-stream with zero force.
    """
    hmin = float(np.min(np.abs(np.diag(np.asarray(h, dtype=float)))))
    if nspec.r_list > 0.5 * hmin:
        raise ValueError(
            f"material {spec.name!r}: neighbor range {nspec.r_list:.2f} A "
            f"violates the minimum-image bound (box min height {hmin:.2f} A); "
            "enlarge the box or reduce the cutoff/skin"
        )
    k_need = NB.max_in_range(pos, h, nspec.cutoff + 0.5 * nspec.skin)
    if nspec.k_max < k_need:
        raise ValueError(
            f"material {spec.name!r}: neighbor list width k_max={nspec.k_max} "
            f"< {k_need} neighbors within cutoff+skin/2 — in-cutoff pairs "
            "would be silently dropped; raise neighbor_k"
        )
    occ = NB.max_cell_occupancy(nspec, pos, h)
    if occ > nspec.cell_capacity:
        raise ValueError(
            f"material {spec.name!r}: fullest cell holds {occ} atoms "
            f"> cell_capacity={nspec.cell_capacity}"
        )



def build_system(spec: MaterialSpec, dtype=jnp.float64) -> tuple[E.MDSystem, E.MDState]:
    # set-up array work (topology tables, validation scans) is many small
    # eager ops; on an accelerator backend the builder runs them on the
    # host CPU and the compute path transfers the finished arrays once
    # (whether this pays on the H100 is unmeasured)
    cpus = None
    if jax.default_backend() != "cpu":
        try:
            cpus = jax.devices("cpu")
        except RuntimeError:
            cpus = None
    if cpus:
        with jax.default_device(cpus[0]):
            sys_, st = _build_system(spec, dtype)
        # the state is an explicit argument of user jits — move it to the
        # accelerator; everything hanging off MDSystem flows into traces
        # as closure constants and is placed at compile time
        dev = jax.devices()[0]
        st = jax.tree_util.tree_map(lambda x: jax.device_put(x, dev), st)
        return sys_, st
    return _build_system(spec, dtype)


def _build_system(spec: MaterialSpec, dtype=jnp.float64) -> tuple[E.MDSystem, E.MDState]:
    use_onehot = False
    if spec.force_field == "sw":
        cxyz = spec.n_cells_xyz or (spec.n_cells,) * 3
        pos, h = lattice.diamond(spec.a0, *cxyz)
        n = len(pos)
        ff = spec.sw
        cutoff = ff.cutoff
        # SW cutoff spans only the first two diamond shells (16 atoms);
        # 20 slots cover moderate compression
        k_max = spec.neighbor_k if spec.neighbor_k is not None else 20
        # boxes of 512 atoms or more use the tile-local one-hot structure
        # (neighbor_onehot.py); smaller ones the gather neighbor list
        use_onehot = n >= 512
    elif spec.force_field == "lj":
        pos, h = lattice.fcc(spec.a0, spec.n_cells, spec.n_cells, spec.n_cells)
        n = len(pos)
        ff = LJmod.single_type(spec.lj_epsilon, spec.lj_sigma, spec.lj_cutoff, n, dtype)
        cutoff = spec.lj_cutoff
        k_max = max(spec.neighbor_k or 32,
                    NB.required_k(n, np.asarray(h), cutoff + 1.0))
        k_max = ((k_max + 7) // 8) * 8
    elif spec.force_field == "opls":
        from . import data_io

        if spec.data_file:
            data = data_io.read_data(spec.data_file)
        elif spec.allatom:
            data = data_io.build_pe_melt_allatom(
                spec.n_chains, spec.chain_length, density=spec.pe_density)
        else:
            data = data_io.build_alkane_melt(spec.n_chains, spec.chain_length)
        ff = data_io.to_opls(
            data, lj_cutoff=spec.opls_lj_cutoff,
            coul_cutoff=spec.opls_coul_cutoff,
            use_ewald=spec.use_ewald, dtype=dtype, kspace=spec.kspace,
        )
        n = len(data.pos)
        cutoff = ff.cutoff
        # fix shake ... m 1.0 (in.strain.lammps): bonds involving mass-1
        # atoms held rigid at the bond style's r0
        cons = None
        shake_on = spec.shake if spec.shake is not None else spec.allatom
        if shake_on:
            from . import constraints as CN

            mt = data.masses[data.types]
            b = np.asarray(data.bonds)
            sel = (mt[b[:, 0]] < 1.5) | (mt[b[:, 1]] < 1.5)
            if bool(sel.any()):
                d0 = np.asarray(data.bond_coeffs)[
                    np.asarray(data.bond_types)[sel], 1]
                cons = CN.from_bonds(jnp.asarray(b[sel], jnp.int32),
                                     jnp.asarray(d0, dtype))
        # size the list from density, not a constant: the default melt has
        # ~134 neighbors within the 10 A cutoff — a 96-wide list silently
        # drops in-cutoff pairs (wrong LJ/Coulomb stresses)
        k_max = max(spec.neighbor_k or 32,
                    NB.required_k(n, data.box, cutoff + 1.0))
        k_max = ((k_max + 7) // 8) * 8
        nspec = NB.derive_spec(n, data.box, cutoff=cutoff, skin=1.0, k_max=k_max)
        if spec.validate:
            _validate_setup(spec, data.pos, data.box, nspec)
        sys = E.MDSystem(
            ff=ff,
            masses=jnp.asarray(data.masses[data.types], dtype=dtype),
            nspec=nspec,
            units=REAL,
            rebuild_every=spec.rebuild_every,
            constraints=cons,
        )
        st = E.init_state(jnp.asarray(data.pos, dtype=dtype),
                          jnp.asarray(data.box, dtype=dtype))
        return sys, st
    elif spec.force_field == "reax":
        # pair_style reax/c + fix qeq/reax (lammps_scripts_reax/
        # in.set.lammps:13-15) — the neighbor-list bond-order field
        # (forcefields/reax.ReaxFFList; reax_impl="dense" keeps the
        # O(N^2) parity twin).  Structures come from the same builders
        # as OPLS: a LAMMPS data file (atom_style charge) or the
        # all-atom PE melt; element identity is inferred from masses.
        from . import data_io
        from .forcefields.reax import build_reax

        if spec.data_file:
            data = data_io.read_data(spec.data_file)
        else:
            data = data_io.build_pe_melt_allatom(
                spec.n_chains, spec.chain_length, density=spec.pe_density)
        n = len(data.pos)
        if spec.reax_impl == "dense" and n > 2048:
            raise ValueError(
                f"reax box has {n} atoms; the dense bond-order field is "
                "sized for the HMM per-qp regime (<= 2048) — use the "
                "default reax_impl='list'")
        if not spec.reax_ffield:
            raise ValueError(
                "force_field='reax' needs reax_ffield (path to a "
                "ffield.reax parameter file)")
        masses_np = data.masses[data.types]
        ff = build_reax(
            spec.reax_ffield, list(spec.reax_elements), masses_np,
            dtype=dtype, top_k=spec.reax_top_k, qeq=spec.qeq,
            impl=spec.reax_impl)
        cutoff = ff.cutoff
        # the list field consumes the engine neighbor list directly:
        # size K to cover every pair inside the taper radius (hbond's
        # 7.5 A and the ~5 A bond region are subsets of swb = 10 A)
        k_need = NB.required_k(n, np.asarray(data.box, float),
                               cutoff + 1.0)
        nspec = NB.derive_spec(n, data.box, cutoff=cutoff, skin=1.0,
                               k_max=min(k_need, max(n - 1, 1)))
        if spec.validate:
            # the dense field needs no neighbor list — only the
            # minimum-image bound applies (taper cutoff < half box)
            hmin = float(np.min(np.abs(np.diag(np.asarray(
                data.box, dtype=float)))))
            if cutoff > 0.5 * hmin:
                raise ValueError(
                    f"material {spec.name!r}: reax taper cutoff "
                    f"{cutoff:.1f} A violates the minimum-image bound "
                    f"(box min height {hmin:.2f} A)")
        sys = E.MDSystem(
            ff=ff,
            masses=jnp.asarray(masses_np, dtype=dtype),
            nspec=nspec,
            units=REAL,
            rebuild_every=spec.rebuild_every,
        )
        st = E.init_state(jnp.asarray(data.pos, dtype=dtype),
                          jnp.asarray(data.box, dtype=dtype))
        return sys, st
    else:
        raise NotImplementedError(
            f"force field {spec.force_field!r} is not implemented"
        )
    nspec = NB.derive_spec(n, np.asarray(h), cutoff=cutoff, skin=1.0, k_max=k_max)
    if spec.validate:
        _validate_setup(spec, np.asarray(pos), np.asarray(h), nspec)
    ohspec = None
    if use_onehot:
        from . import neighbor_onehot as OH

        density = n / float(np.prod(np.diag(np.asarray(h))))
        perm = OH.spatial_sort(np.asarray(pos), np.asarray(h),
                               brick=(128.0 / density) ** (1.0 / 3.0))
        pos = np.asarray(pos)[perm]
        ohspec = OH.derive_onehot_spec(n, np.asarray(h), cutoff=cutoff,
                                       skin=1.0, k=k_max)
        ff = OH.SWOneHot(sw=ff, spec=ohspec)
    spatial = None
    if spec.spatial_shards > 0:
        if spec.force_field != "sw":
            raise ValueError("spatial_shards: only SW boxes have a "
                             "sharded force path (P4)")
        from jax.sharding import Mesh
        from ..parallel import spatial_md as SP

        k = spec.spatial_shards
        devs = jax.devices()
        if len(devs) < k:
            raise ValueError(
                f"spatial_shards={k} but only {len(devs)} devices")
        sg = SP.derive_sharded_grid(n, np.asarray(h), cutoff=cutoff,
                                    skin=0.5, n_shards=k)
        spatial = SP.SpatialRunner(
            sg=sg, mesh=Mesh(np.array(devs[:k]), ("md",)))
    sys = E.MDSystem(
        ff=ff,
        masses=jnp.full((n,), spec.mass, dtype=dtype),
        nspec=nspec,
        units=REAL,
        rebuild_every=spec.rebuild_every,
        onehot=ohspec,
        spatial=spatial,
    )
    st = E.init_state(jnp.asarray(pos, dtype=dtype), jnp.asarray(h, dtype=dtype))
    return sys, st


def equilibrate(
    sys: E.MDSystem,
    state: E.MDState,
    params: MDParams,
    key,
    minimize_steps: int = 100,
    equil_steps: int = 200,
) -> E.MDState:
    """Minimize then thermalize (the in.init.lammps prep, simplified: the
    staged NPT heatup/cooldown cycle becomes FIRE + NVT at the target
    temperature; box stays at the lattice volume)."""
    # dt0 is force-field-aware: stiff reactive fields declare a smaller
    # stable FIRE step (forcefields/reax.py fire_dt0)
    state = jax.jit(lambda s: E.minimize_fire(
        sys, s, n_steps=minimize_steps,
        dt0=getattr(sys.ff, "fire_dt0", 0.5)))(state)
    vel = E.maxwell_velocities(sys, key, max(params.temperature, 1e-6),
                               dtype=state.pos.dtype)
    state = state._replace(vel=vel)
    if equil_steps > 0:
        state = jax.jit(
            lambda s: E.run_nvt(sys, s, equil_steps, params.temperature, params.dt)
        )(state)
    return state


def equilibrate_staged(
    sys: E.MDSystem,
    state: E.MDState,
    params: MDParams,
    key,
    ns_init: int = 100,
    minimize_steps: int = 100,
) -> E.MDState:
    """The reference's full heatup/cooldown material-prep cycle
    (in.init.lammps): minimize -> NVT@300 -> NPT 300->500 -> NPT@500 (5x)
    -> NPT 500->T -> NPT@T (2x), isotropic 1 atm barostat.  ``ns_init``
    scales all stage lengths like the script's ``nsinit``."""
    T = params.temperature
    dt = params.dt
    state = E.minimize_fire(sys, state, n_steps=minimize_steps,
                            dt0=getattr(sys.ff, "fire_dt0", 0.5))
    state = state._replace(
        vel=E.maxwell_velocities(sys, key, 200.0, dtype=state.pos.dtype)
    )
    state = E.run_nvt(sys, state, ns_init, 300.0, dt)
    state = E.run_npt(sys, state, ns_init, 300.0, 500.0, dt)
    state = E.run_npt(sys, state, 5 * ns_init, 500.0, 500.0, dt)
    state = E.run_npt(sys, state, ns_init, 500.0, T, dt)
    state = E.run_npt(sys, state, 2 * ns_init, T, T, dt)
    return state


def make_measure_fn(sys: E.MDSystem, params: MDParams,
                    thermal_stiffness: bool = False):
    """Jitted core of :func:`measure`.  Build ONCE per (system, params)
    and reuse across replicas — jitting fresh lambdas per call (the old
    behavior) recompiled the sampling + 12-probe stiffness program for
    every replica, paying the full XLA compile repeatedly."""

    @jax.jit
    def _measure(state):
        st2, press = E.sample_stress(sys, state, params.nsteps_sample,
                                     params.temperature, params.dt)
        C = stiffness_probe(sys, st2, params, thermal=thermal_stiffness)
        return press, C

    return _measure


def measure(
    sys: E.MDSystem,
    state: E.MDState,
    params: MDParams,
    thermal_stiffness: bool = False,
    measure_fn=None,
) -> InitData:
    """Measure equilibrium box lengths, residual stress, stiffness, density
    (init_material_problem.h:192-295).  Pass a :func:`make_measure_fn`
    result as ``measure_fn`` when measuring several replicas."""
    L, _ = B.lengths_tilts(state.h)
    fn = measure_fn or make_measure_fn(sys, params, thermal_stiffness)
    press, C = fn(state)
    stress = -press * ATM_TO_PA
    vol = float(B.volume(state.h))
    density = float(jnp.sum(sys.masses)) * DENSITY_CONV / vol
    return InitData(
        length=np.asarray(L),
        stress=np.asarray(stress),
        stiff=np.asarray(C),
        density=density,
    )


def write_init_files(outdir: str, name: str, replica: int, data: InitData) -> None:
    """Reference-format init.<mat>_<n>.{length,stress,stiff} text files
    (read_write.h formats; density file is written per material by
    average_replica_data, stmd_sync.h:477-487)."""
    from ..utils import io_tensors as io
    import os

    os.makedirs(outdir, exist_ok=True)
    base = f"{outdir}/init.{name}_{replica}"
    io.write_vector(base + ".length", data.length)
    io.write_sym2(base + ".stress", _voigt_to_sym_np(data.stress))
    io.write_sym4(base + ".stiff", _c66_to_rank4_np(data.stiff))


def _voigt_to_sym_np(v):
    t = np.zeros((3, 3))
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    for k, (i, j) in enumerate(pairs):
        t[i, j] = v[k]
        t[j, i] = v[k]
    return t


def _c66_to_rank4_np(c66):
    from ..utils import tensors as T

    return np.asarray(T.c66_to_rank4(jnp.asarray(c66)))
