"""Full HMM with the real on-device MD backend at the quadrature points.

This is the north-star path (BASELINE.json): the reference's
STMDSync::update fleet step (stmd_sync.h:1070-1132) as one batched device
computation — job packing, per-(qp x replica) strain-driven MD with
persistent microstates, virial-stress homogenization, init-stress
subtraction, replica averaging, and scatter-back into the FE stress field.

Persistent microstates: the reference's per-qp LAMMPS restart files
(``last.<qpid>.<mat>_<r>.dump``, stmd_problem.h:114-273) become a stacked
MDState pytree [n_qp, n_repl, ...] in device memory.  The ``most_recent_qp_id``
branching rule (a qp deduplicated onto another inherits that source's
microstate when it first runs its own MD, stmd_problem.h:114-138) becomes a
gather over the qp axis.

Job dispatch: a fixed-capacity job list (config 'maximum md jobs', default
all qps) filled via masked nonzero — the static-shape replacement for the
reference's dynamic MPI batch scheduler (set_md_procs, stmd_sync.h:189-278).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HMMConfig
from ..bridging import bridge
from ..fem import shapes
from ..fem import fe_problem as FE
from ..fem.problem_types import make_problem
from ..fem.state import init_qp_state
from ..md import engine as E
from ..md import material as M
from ..md.homogenization import MDParams, strain_and_homogenize
from ..utils import tensors as T
from .problem import HMMProblem, assign_materials


class MicroStates(NamedTuple):
    """Persistent per-(qp, replica) MD microstates."""

    pos: jax.Array  # (n_qp, n_repl, N, 3)
    vel: jax.Array
    h: jax.Array  # (n_qp, n_repl, 3, 3)
    vxi: jax.Array  # (n_qp, n_repl, NHC_LEN)
    has_run: jax.Array  # (n_qp,) bool — last.<qpid>.dump exists


def broadcast_micro(state: E.MDState, n_qp: int, n_repl: int) -> MicroStates:
    """Tile one or a per-replica stack of equilibrated states over qps.

    ``state`` leaves may be unbatched (shared across replicas) or carry a
    leading (n_repl,) axis (distinct equilibrated replicas — the
    reference's init.<mat>_<r>.bin per-replica restarts).
    """
    base_ndim = 2  # pos/vel are (N, 3)

    def bc(x, nd):
        if x.ndim == nd + 1:  # already per-replica
            return jnp.broadcast_to(x, (n_qp,) + x.shape)
        return jnp.broadcast_to(x, (n_qp, n_repl) + x.shape)

    return MicroStates(
        pos=bc(state.pos, base_ndim),
        vel=bc(state.vel, base_ndim),
        h=bc(state.h, 2),
        vxi=bc(state.vxi, 1),
        has_run=jnp.zeros((n_qp,), dtype=bool),
    )


@dataclass(frozen=True)
class MDBackend:
    """Static MD-side configuration for the coupling."""

    sys: E.MDSystem
    params: MDParams
    ensemble: bridge.ReplicaEnsemble
    n_repl: int
    max_jobs: int  # static job-list capacity
    initial_md_state: E.MDState = None  # the equilibrated replica microstate
    device_mesh: object = None  # jax Mesh — shard the job batch over "md"
    job_chunk: int = 64  # jobs per scan chunk (bounds program memory)

    def make_update_fn(self):
        """Returns (update_fn, init_micro_carry_handling) for HMMProblem.

        update_fn(micro, eps_cg, material, jobs, most_recent_id)
            -> (micro', update_stress_cg)
        """

        def update_fn(micro: MicroStates, eps_cg, material, jobs, most_recent_id,
                      timestep=0):
            n_qp = eps_cg.shape[0]
            K = self.max_jobs

            # -- job packing (write_md_updates_list + prepare_md_simulations)
            # rotate the selection window by timestep so a capacity smaller
            # than the flagged count round-robins over qps instead of
            # starving high indices (flags are sticky)
            offset = (jnp.asarray(timestep, jnp.int32) * K) % n_qp
            rolled = jnp.roll(jobs, -offset)
            idx_r = jnp.nonzero(rolled, size=K, fill_value=0)[0]
            slot_valid = jnp.arange(K) < jnp.sum(jobs)
            # invalid slots get an out-of-range sentinel: OOB gathers clamp
            # (their rows are masked anyway) and OOB scatters drop — a
            # fill_value of 0 would make every empty slot alias qp `offset`,
            # and XLA's duplicate-index .set order is unspecified (a flagged
            # qp could nondeterministically receive a stale microstate)
            job_idx = jnp.where(
                slot_valid, (idx_r + offset) % n_qp, n_qp
            ).astype(jnp.int32)

            # microstate source: own if it has run, else borrowed from
            # most_recent provider if that ran, else the fresh initial state
            mri = most_recent_id[job_idx]
            mri_ok = (mri < n_qp) & micro.has_run[jnp.clip(mri, 0, n_qp - 1)]
            src = jnp.where(
                micro.has_run[job_idx],
                job_idx,
                jnp.where(mri_ok, jnp.clip(mri, 0, n_qp - 1), job_idx),
            )
            # a qp that never ran and has no valid provider starts fresh —
            # index job_idx then rows where has_run[src] is False hold the
            # broadcast initial state anyway (micro starts all-initial).

            jpos = micro.pos[src]  # (K, n_repl, N, 3)
            jvel = micro.vel[src]
            jh = micro.h[src]
            jvxi = micro.vxi[src]

            # -- strain to replica frames and length variation
            eps_job = eps_cg[job_idx]  # (K, 6)
            mat_job = material[job_idx]
            eps_rep = bridge.replica_strains(self.ensemble, eps_job, mat_job)
            dlength = bridge.strain_to_length_variation(
                self.ensemble, eps_rep, mat_job
            )  # (K, n_repl, 6)

            # -- batched MD (execute_inside_md_simulations)
            md_dtype = micro.pos.dtype

            def one(pos, vel, h, vxi, dl):
                st = E.MDState(pos=pos, vel=vel, h=h, vxi=vxi)
                st, stress = strain_and_homogenize(
                    self.sys, st, dl.astype(md_dtype), self.params)
                return st.pos, st.vel, st.h, st.vxi, stress

            # padding slots (slot_valid False) run full MD too: the vmapped
            # loops run every slot to the batch's largest step count, and
            # the scatter below drops their results
            run = jax.vmap(jax.vmap(one))
            if self.device_mesh is not None:
                # the reference's P3 task parallelism (MD batches round-
                # robined over communicators, stmd_sync.h:189-278, 583)
                # becomes a shard_map of the job axis over the mesh
                from jax import shard_map
                from jax.sharding import PartitionSpec as P

                axes = tuple(self.device_mesh.axis_names)
                run = shard_map(
                    run,
                    mesh=self.device_mesh,
                    in_specs=(P(axes),) * 5,
                    out_specs=(P(axes),) * 5,
                    check_vma=False,
                )

            # process the job list in fixed-size chunks via lax.scan (the
            # reference's round-robin batching, stmd_sync.h:583); the chunk
            # trades device memory for sequential latency (PERF.md)
            ch = min(self.job_chunk, K)
            n_dev = 1
            if self.device_mesh is not None:
                n_dev = self.device_mesh.size
                ch = max(ch, n_dev)
            # largest divisor of K not exceeding job_chunk that is ALSO a
            # multiple of the device count (the shard_map over the mesh
            # needs every chunk divisible by n_dev; K itself is rounded
            # up to a multiple of n_dev at build time)
            while K % ch != 0 or ch % n_dev != 0:
                ch -= 1
                if ch < n_dev:
                    ch = n_dev  # K % n_dev == 0 by construction
                    break

            def chunked(arrs):
                shape = lambda x: x.reshape((K // ch, ch) + x.shape[1:])
                scanned = jax.lax.scan(
                    lambda _, a: (None, run(*a)),
                    None,
                    tuple(shape(x) for x in arrs),
                )[1]
                return tuple(
                    x.reshape((K,) + x.shape[2:]) for x in scanned
                )

            npos, nvel, nh, nvxi, sigma_rep = chunked(
                (jpos, jvel, jh, jvxi, dlength)
            )
            sigma_rep = sigma_rep.astype(eps_cg.dtype)

            # -- replica averaging with init-stress subtraction
            upd = bridge.average_replica_stresses(
                self.ensemble, sigma_rep, mat_job, subtract_init_stress=True
            )  # (K, 6)

            # -- scatter back: stresses dense over qps, microstates updated;
            # has_result records which qps actually received MD stresses
            # (job capacity may be smaller than the flagged count)
            update_stress_cg = jnp.zeros((n_qp, 6), dtype=eps_cg.dtype)
            update_stress_cg = update_stress_cg.at[job_idx].set(upd, mode="drop")
            has_result = (
                jnp.zeros((n_qp,), dtype=jnp.int32)
                .at[job_idx]
                .add(1, mode="drop")
                > 0
            )

            def scat(old, new):
                return old.at[job_idx].set(new, mode="drop")

            ran = jobs & has_result
            micro = MicroStates(
                pos=scat(micro.pos, npos),
                vel=scat(micro.vel, nvel),
                h=scat(micro.h, nh),
                vxi=scat(micro.vxi, nvxi),
                has_run=micro.has_run | ran,
            )
            # raw per-replica stresses dense over qps (mddata CSV logs)
            stress_repl_cg = (
                jnp.zeros((n_qp, self.n_repl, 6), dtype=eps_cg.dtype)
                .at[job_idx].set(sigma_rep, mode="drop")
            )
            return micro, update_stress_cg, has_result, stress_repl_cg

        return update_fn


@dataclass(frozen=True)
class MDHMMProblem:
    """HMM coupled to the real MD backends (one per material);
    state = (FEState, tuple[MicroStates, ...])."""

    base: HMMProblem
    backends: tuple  # tuple[MDBackend, ...], indexed by material

    @property
    def backend(self) -> MDBackend:  # single-material convenience
        return self.backends[0]

    @property
    def geom(self):
        return self.base.geom

    @property
    def cfg(self):
        return self.base.cfg

    def init_state(self):
        fe = self.base.init_state()
        return fe, self._fresh_micro()

    def _fresh_micro(self) -> tuple:
        return tuple(
            broadcast_micro(be.initial_md_state, self.geom.n_qp_total, be.n_repl)
            for be in self.backends
        )

    def step(self, carry):
        fe_state, micros = carry
        ops = self.base.ops
        fe_state = FE.begin_step(ops, fe_state)
        fe_state, out = FE.solve(ops, fe_state)

        from .problem import clustering_mapping

        p = self.cfg.precision
        id_to_get, cluster_saturated = clustering_mapping(
            fe_state, out.flags, p.clustering_min_steps, p.spline_points,
            p.clustering_diff_threshold,
        )
        fe_state = fe_state._replace(
            hist=fe_state.hist._replace(id_to_get_results_from=id_to_get)
        )
        jobs = bridge.job_mask(out.flags, id_to_get)

        # per-material MD fleets (materials may have different box sizes,
        # so each keeps its own MicroStates pytree; job masks are disjoint)
        n_qp = out.flags.shape[0]
        update_stress_cg = jnp.zeros((n_qp, 6), dtype=out.update_strain_cg.dtype)
        has_result = jnp.zeros((n_qp,), dtype=bool)
        n_repl = max(be.n_repl for be in self.backends)
        stress_repl = jnp.zeros((n_qp, n_repl, 6),
                                dtype=out.update_strain_cg.dtype)
        new_micros = []
        for m, be in enumerate(self.backends):
            jobs_m = jobs & (out.material == m)
            update_fn = be.make_update_fn()
            micro_m, upd_m, hr_m, srepl_m = update_fn(
                micros[m], out.update_strain_cg,
                jnp.zeros_like(out.material),  # local material index
                jobs_m, out.most_recent_id,
                timestep=fe_state.timestep,
            )
            new_micros.append(micro_m)
            update_stress_cg = update_stress_cg + upd_m
            has_result = has_result | hr_m
            stress_repl = stress_repl.at[:, : be.n_repl, :].add(srepl_m)
        micro = tuple(new_micros)

        # a flagged qp whose (possibly deduplicated) source didn't fit the
        # job capacity falls back to the tangent update this step — never a
        # zeroed stress
        updated = out.flags & has_result[id_to_get]
        fe_state, res1 = FE.apply_stress_update(
            ops, fe_state, updated, update_stress_cg, id_to_get
        )
        from ..fem import assembly

        rf = assembly.reaction_force(
            self.geom, fe_state.qp.new_stress, fe_state.qp.rho,
            self.base.problem.loaded_mask.astype(fe_state.u.dtype) > 0,
        )
        fe_state = FE.end_step(ops, fe_state)
        from .problem import StepOutputs

        return (fe_state, micro), StepOutputs(
            residual0=out.residual,
            residual1=res1,
            n_flagged=jnp.sum(out.flags),
            # jobs *executed* this step (job capacity may round-robin a
            # larger flagged set) — not the requested count
            n_jobs=jnp.sum(has_result),
            reaction_force=rf,
            md_ran=has_result,
            md_strain_cg=out.update_strain_cg,
            md_stress_repl=stress_repl,
            cluster_saturated=cluster_saturated,
        )


def build_md_hmm(
    cfg: HMMConfig,
    spec: M.MaterialSpec | None = None,
    specs: list | None = None,
    equil_steps: int = 100,
    minimize_steps: int = 100,
    device_mesh=None,
    staged: bool = False,
    ns_init: int = 100,
) -> MDHMMProblem:
    """Assemble the full MD-coupled HMM from a reference-format config.

    Runs material initialization (equilibrate + measure) on device first —
    the reference requires a separate ``init_material`` run producing
    nanoscale_input files (dealammps.cc:507 ordering constraint); here it
    is one call.  One MD backend per material (different box sizes are
    fine); ``spec``/``specs`` override the per-material MaterialSpec.
    """
    dtype = jnp.dtype(cfg.dtype)
    md_dtype = jnp.dtype(cfg.md_dtype)
    n_repl = cfg.material.number_of_replicas
    materials = list(cfg.material.materials)

    specs_auto = specs is None and spec is None
    if specs is None:
        if spec is not None:
            specs = [
                M.MaterialSpec(
                    **{**spec.__dict__, "name": name}
                ) for name in materials
            ] if len(materials) > 1 else [spec]
        else:
            from ..config import md_spec_kwargs

            kw = md_spec_kwargs(cfg)  # force field + reax ffield path
            specs = [M.MaterialSpec(name=name, **kw) for name in materials]
    assert len(specs) == len(materials)

    params = MDParams(
        temperature=cfg.md.temperature,
        dt=cfg.md.timestep_length,
        strain_rate=cfg.md.strain_rate,
        nsteps_sample=cfg.md.nsteps_sample,
    )

    problem = make_problem(cfg, dtype)
    geom = shapes.precompute_geometry(
        problem.mesh.nodes, problem.mesh.cells, cfg.mesh.quadrature_formula, dtype=dtype
    )
    # auto capacity: every flagged qp runs MD every macro-step, exactly like
    # the reference (stmd_sync.h:570-618) — the job list is processed in
    # job_chunk-sized lax.scan chunks, so device-program size stays bounded
    # regardless of capacity.  'maximum md jobs' still bounds per-step cost
    # like the reference's PJM node budget (P8) — qps beyond it round-robin
    # with tangent fallback.
    max_jobs = min(cfg.resources.max_md_jobs or geom.n_qp_total,
                   geom.n_qp_total)
    if device_mesh is not None:
        n_dev = device_mesh.size  # job axis spans every mesh axis
        max_jobs = ((max_jobs + n_dev - 1) // n_dev) * n_dev

    # per-replica nanostructure metadata: orientation (normal_vector ->
    # rotation to common ground), density, and any pre-measured init.*
    # equilibration data (stmd_sync.h:280-489); missing files fall back
    # to identity orientation + on-device measurement
    from ..bridging.replica_data import load_replica_metadata

    meta = load_replica_metadata(
        cfg.dirs.nanoscale_input, materials, n_repl,
        cg_vector=cfg.material.common_ground_vector,
    )

    # the reference's 'minimum number of cores for MD simulation' knob
    # (set_md_procs: LAMMPS ranks per job) maps to P4 spatial sharding
    # for boxes beyond 2048 atoms — small boxes run unsharded, hundreds
    # of them batched on one device
    k_md = cfg.resources.md_cores_min
    if k_md > 1 and specs_auto:
        for mi, ms in enumerate(specs):
            cells = ms.n_cells_xyz or (ms.n_cells,) * 3
            n_est = 8 * int(np.prod(cells))
            if (ms.force_field == "sw" and ms.spatial_shards == 0
                    and n_est > 2048 and len(jax.devices()) >= k_md):
                specs[mi] = M.MaterialSpec(
                    **{**ms.__dict__, "spatial_shards": k_md})

    # reference LAMMPS binary restarts (init.<mat>_<n>.bin,
    # stmd_problem.h:185-207 read_restart): when present, the material's
    # box geometry comes from the restart file itself — adapt the SW
    # lattice cell counts so the built system matches it atom-for-atom
    if spec is None and specs_auto:
        for mi, mspec in enumerate(specs):
            micro = meta[mi][0].micro
            if micro is None or mspec.force_field != "sw":
                continue
            L = micro.boxhi - micro.boxlo
            cells = tuple(int(round(l / mspec.a0)) for l in L)
            if min(cells) >= 1 and 8 * cells[0] * cells[1] * cells[2] \
                    == micro.natoms:
                specs[mi] = M.MaterialSpec(
                    **{**mspec.__dict__, "n_cells_xyz": cells,
                       "a0": float(np.mean(L / np.asarray(cells)))})

    # material initialization (init_material equivalent): each material x
    # replica equilibrated with its own thermal seed and measured
    # independently (init_material_sync/problem.h per-replica data)
    backends = []
    stiff_rows, rho_rows = [], []
    for mi, mspec in enumerate(specs):
        sys, st_init = M.build_system(mspec, dtype=md_dtype)
        rep_states, rep_data = [], []
        # one jitted prep + measure program per material, reused across
        # replicas (fresh per-replica lambdas would recompile everything)
        if staged:
            # the reference's in.init.lammps heatup/cooldown NPT cycle
            # (production material prep; `equilibrate` is the fast path
            # for tests/debug)
            prep_fn = jax.jit(lambda key, _s=sys: M.equilibrate_staged(
                _s, st_init, params, key, ns_init=ns_init,
                minimize_steps=minimize_steps))
        else:
            prep_fn = jax.jit(lambda key, _s=sys: M.equilibrate(
                _s, st_init, params, key, minimize_steps=minimize_steps,
                equil_steps=equil_steps))
        measure_fn = M.make_measure_fn(sys, params)
        for r in range(n_repl):
            key = jax.random.PRNGKey(cfg.seed + 101 * mi + r)
            mr = meta[mi][r]
            if mr.micro is not None and mr.micro.natoms == sys.n_atoms:
                # seed from the reference's own equilibrated binary
                # restart instead of re-equilibrating on device
                # (read_restart semantics, stmd_problem.h:185-207)
                st_r = E.init_state(
                    jnp.asarray(mr.micro.pos - mr.micro.boxlo,
                                dtype=md_dtype),
                    jnp.asarray(mr.micro.h, dtype=md_dtype),
                    vel=jnp.asarray(mr.micro.vel, dtype=md_dtype))
            else:
                st_r = prep_fn(key)
            rep_states.append(st_r)
            if mr.length is not None and mr.stress is not None \
                    and mr.stiff is not None:
                # reference-format init.* files take precedence (the
                # load_replica_equilibration_data path)
                rep_data.append(M.InitData(
                    length=mr.length, stress=mr.stress, stiff=mr.stiff,
                    density=mr.rho if mr.rho is not None else 1000.0,
                ))
            else:
                measured = M.measure(sys, st_r, params,
                                     measure_fn=measure_fn)
                if mr.rho is not None:
                    measured = M.InitData(
                        length=measured.length, stress=measured.stress,
                        stiff=measured.stiff, density=mr.rho,
                    )
                rep_data.append(measured)
        st0 = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rep_states)

        rotams = jnp.stack(
            [jnp.asarray(meta[mi][r].rotam, dtype=dtype) for r in range(n_repl)]
        )[None]  # (1, n_repl, 3, 3)
        ens = bridge.ReplicaEnsemble(
            rotam=rotams,
            init_length=jnp.stack(
                [jnp.asarray(d.length, dtype=dtype) for d in rep_data])[None],
            init_stress=jnp.stack(
                [jnp.asarray(d.stress, dtype=dtype) for d in rep_data])[None],
            init_stiff=jnp.stack(
                [jnp.asarray(d.stiff, dtype=dtype) for d in rep_data])[None],
            rho=jnp.asarray([[d.density for d in rep_data]], dtype=dtype),
        )
        # reax job programs are heavier per job than lj/opls/sw: the list
        # field's per-job autodiff residuals are O(N K_nb) + O(N K_b^3), so
        # the chunk is bounded by a slot budget — jobs x atoms x slots x
        # replicas per device program <= ~2M (unmeasured on the H100)
        chunk = 64
        if mspec.force_field == "reax":
            slots = sys.nspec.k_max
            chunk = max(1, min(
                64,
                2_000_000 // max(sys.n_atoms * slots * max(n_repl, 1), 1)))
        backends.append(MDBackend(
            sys=sys, params=params, ensemble=ens, n_repl=n_repl,
            max_jobs=max_jobs, initial_md_state=st0, device_mesh=device_mesh,
            job_chunk=chunk,
        ))
        sc, rc = bridge.average_replica_data(ens)
        stiff_rows.append(sc[0])
        rho_rows.append(rc[0])

    stiff_cg = jnp.stack(stiff_rows)  # (n_mat, 6, 6)
    rho = jnp.stack(rho_rows)  # (n_mat,)
    mat = assign_materials(cfg, geom, dtype)
    qp = init_qp_state(geom.n_qp_total, mat, rho, stiff_cg, dtype=dtype)
    ops = FE.make_ops(
        geom, problem, qp,
        cfg.time.timestep_length,
        cfg.bridging.stress_method,
        False,
        cfg.precision.min_quadrature_strain_norm,
    )
    base = HMMProblem(
        cfg=cfg, problem=problem, geom=geom, ops=ops,
        ensemble=backends[0].ensemble, md_update_fn=None, dtype=dtype,
    )
    return MDHMMProblem(base=base, backends=tuple(backends))
