"""Top-level HMM coupler: one SPMD program for the FE + MD time loop.

Functional port of HMMProblem (dealammps.cc:101-537).  Where the reference
splits MPI_COMM_WORLD into FE and MD communicators and broadcasts
ScaleBridgingData between them (dealammps.cc:344-415), here FE and MD phases
are sequential device-wide computations inside one jitted step; the
"communication" is array indexing in device memory.

The per-timestep sequence (do_timestep, dealammps.cc:418-474; the Newton
loop runs exactly once):

    begin_step  -> solve -> [clustering dedup] -> md_update -> check -> end_step
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..config import HMMConfig
from ..fem import shapes
from ..fem import fe_problem as FE
from ..fem import assembly
from ..fem.problem_types import make_problem, Problem
from ..fem.state import FEState, init_qp_state, init_history, init_fe_state
from ..bridging import bridge
from ..utils import tensors as T


def clustering_mapping(state, flags, min_steps: int, n_points: int, threshold: float):
    """Strain-history similarity dedup: which qp sources each qp's stress.

    The reference's history_analysis pipeline (FE_problem.h:1166-1291):
    splinify flagged histories, ring-compare L2 distances, reduce the
    similarity graph, read back mapping.csv.  Active only after
    ``min steps`` timesteps (FE_problem.h:1277).  Returns the dense
    id_to_get_results_from vector.
    """
    from ..clustering.spline import splinify_histories
    from ..clustering.similarity import similarity_adjacency
    from ..clustering.reduction import reduce_graph

    n_qp = flags.shape[0]
    identity = jnp.arange(n_qp, dtype=jnp.int32)

    # Computed unconditionally and selected instead of under lax.cond (a
    # constraint of the earlier accelerator; unmeasured on the H100) — the
    # clustering cost is small next to the MD phase it gates.
    splines = splinify_histories(state.hist.buffer, state.hist.count, n_points)
    adj = similarity_adjacency(splines, flags, threshold)
    adj = adj & (state.timestep > min_steps)
    mapping, saturated = reduce_graph(adj, return_saturated=True)
    return (jnp.where(state.timestep > min_steps, mapping, identity),
            saturated)


class StepOutputs(NamedTuple):
    residual0: jax.Array  # rhs norm before the stress update
    residual1: jax.Array  # rhs norm after the stress update
    n_flagged: jax.Array  # number of qps flagged for MD
    n_jobs: jax.Array  # number of qps actually running MD (after dedup)
    reaction_force: jax.Array  # loaded-boundary reaction (output_lbc_force)
    # MD-coupled runs only (None on the Hooke/surrogate paths): feed the
    # per-qp mddata CSV logs (stmd_problem.h:394-456)
    md_ran: jax.Array | None = None  # (n_qp,) bool — MD executed this step
    md_strain_cg: jax.Array | None = None  # (n_qp, 6) job strains
    md_stress_repl: jax.Array | None = None  # (n_qp, n_repl, 6) raw stresses
    # True when reduce_graph's pick cap truncated the similarity dedup
    # (remaining qps fell back to identity mapping = extra MD, not wrong
    # stresses) — the CLI logs it so the cap is never a silent cost
    cluster_saturated: jax.Array | None = None


# An md_update_fn maps (eps_cg (n_qp,6), material (n_qp,), jobs_mask (n_qp,),
# most_recent_id (n_qp,)) -> dense update_stress_cg (n_qp, 6).  Rows where
# jobs_mask is False are ignored by apply_stress_update's gather.
MDUpdateFn = Callable[[jax.Array, jax.Array, jax.Array, jax.Array], jax.Array]


@dataclass(frozen=True)
class HMMProblem:
    cfg: HMMConfig
    problem: Problem
    geom: shapes.FEGeometry
    ops: FE.FEOps
    ensemble: bridge.ReplicaEnsemble
    md_update_fn: MDUpdateFn
    dtype: object
    surrogate_fn: object = None  # stress method 2 (bridging/surrogate.py)

    def init_state(self) -> FEState:
        cfg = self.cfg
        n_qp = self.geom.n_qp_total
        mat = assign_materials(cfg, self.geom, self.dtype)
        stiff_cg, rho = bridge.average_replica_data(self.ensemble)
        qp = init_qp_state(n_qp, mat, rho, stiff_cg, dtype=self.dtype)
        capacity = cfg.time.end_timestep - cfg.time.start_timestep + 2
        hist = init_history(n_qp, capacity, dtype=self.dtype)
        return init_fe_state(
            self.geom.n_nodes, qp, hist, cfg.time.start_timestep, dtype=self.dtype
        )

    def step(self, state: FEState) -> tuple[FEState, StepOutputs]:
        """One macro timestep (jittable)."""
        ops = self.ops
        state = FE.begin_step(ops, state)
        state, out = FE.solve(ops, state)

        p = self.cfg.precision
        id_to_get, cluster_saturated = clustering_mapping(
            state, out.flags, p.clustering_min_steps, p.spline_points,
            p.clustering_diff_threshold,
        )
        state = state._replace(
            hist=state.hist._replace(id_to_get_results_from=id_to_get)
        )
        jobs = bridge.job_mask(out.flags, id_to_get)

        if ops.stress_method == 0:
            update_stress_cg = self.md_update_fn(
                out.update_strain_cg, out.material, jobs, out.most_recent_id
            )
        else:
            update_stress_cg = jnp.zeros_like(out.update_strain_cg)

        state, res1 = FE.apply_stress_update(
            ops, state, out.flags, update_stress_cg, id_to_get,
            surrogate_fn=self.surrogate_fn,
        )
        rf = assembly.reaction_force(
            self.geom, state.qp.new_stress, state.qp.rho,
            self.problem.loaded_mask.astype(state.u.dtype) > 0,
        )
        state = FE.end_step(ops, state)
        return state, StepOutputs(
            residual0=out.residual,
            residual1=res1,
            n_flagged=jnp.sum(out.flags),
            n_jobs=jnp.sum(jobs),
            reaction_force=rf,
            cluster_saturated=cluster_saturated,
        )

    def run(self, state: FEState, n_steps: int) -> tuple[FEState, StepOutputs]:
        """Run n_steps with lax.scan (stacked outputs)."""

        def body(s, _):
            s, o = self.step(s)
            return s, o

        return jax.lax.scan(body, state, None, length=n_steps)


def assign_materials(cfg: HMMConfig, geom: shapes.FEGeometry, dtype) -> jax.Array:
    """Random per-cell material from proportions, repeated per qp.

    reference: CellData::generate_nanostructure_uniform (FE.h:177-210) with
    mt19937(time(0)) on rank 0 + MPI_Bcast (FE_problem.h:265-272); here a
    fixed-seed jax PRNG so runs are reproducible.
    """
    props = jnp.asarray(cfg.material.proportions)
    if abs(float(props.sum()) - 1.0) > 1e-4:
        raise ValueError("Material proportions must sum to 1")  # FE.h:185-189
    key = jax.random.PRNGKey(cfg.seed)
    r = jax.random.uniform(key, (geom.n_cells,))
    cum = jnp.cumsum(props)
    cell_mat = jnp.sum(r[:, None] >= cum[None, :], axis=1).astype(jnp.int32)
    return jnp.repeat(cell_mat, geom.n_qp_per_cell)


def build_hooke_hmm(
    cfg: HMMConfig,
    ensemble: bridge.ReplicaEnsemble | None = None,
    device_mesh=None,
    surrogate_fn=None,
) -> HMMProblem:
    """Assemble an HMMProblem with the Hooke's-law fake-MD backend.

    This is the reference's "approximate md with hookes law" debug mode —
    the full orchestration path with sigma = C:eps as the kernel.
    If ``device_mesh`` is given, the MD/bridging phase is shard_mapped over
    its "md" axis (parallel/mesh_utils.py).
    """
    dtype = jnp.dtype(cfg.dtype)
    problem = make_problem(cfg, dtype)
    n_gauss = cfg.mesh.quadrature_formula
    geom = shapes.precompute_geometry(
        problem.mesh.nodes, problem.mesh.cells, n_gauss, dtype=dtype
    )
    if ensemble is None:
        stiff = T.isotropic_c66(3.0e9, 0.35, dtype=dtype)
        ensemble = bridge.uniform_ensemble(
            len(cfg.material.materials), cfg.material.number_of_replicas, stiff, 1200.0, dtype
        )

    def md_update_fn(eps_cg, material, jobs, most_recent_id):
        upd = bridge.hooke_update_stress(ensemble, eps_cg, material)
        return jnp.where(jobs[:, None], upd, 0.0)

    if device_mesh is not None:
        from ..parallel.mesh_utils import shard_md_update

        md_update_fn = shard_md_update(md_update_fn, device_mesh)

    mat = assign_materials(cfg, geom, dtype)
    stiff_cg, rho = bridge.average_replica_data(ensemble)
    qp = init_qp_state(geom.n_qp_total, mat, rho, stiff_cg, dtype=dtype)
    ops = FE.make_ops(
        geom,
        problem,
        qp,
        cfg.time.timestep_length,
        cfg.bridging.stress_method,
        cfg.bridging.approx_md_with_hookes_law,
        cfg.precision.min_quadrature_strain_norm,
    )
    return HMMProblem(
        cfg=cfg,
        problem=problem,
        geom=geom,
        ops=ops,
        ensemble=ensemble,
        md_update_fn=md_update_fn,
        dtype=dtype,
        surrogate_fn=surrogate_fn,
    )
