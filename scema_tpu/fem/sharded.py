"""P2 completed: node- AND qp-sharded FE state over the device mesh.

The base posture (docs/parallelization.md "Scaling ceiling") replicates
FE nodal arrays on every device — the same stance as the reference's
``parallel::shared::Triangulation`` (full mesh copy per rank,
READMEs/Parallelization.md lists distributed triangulations as future
work).  This module removes that ceiling the XLA-idiomatic way: no
hand-rolled halo exchange, just `jax.lax.with_sharding_constraint`
annotations on the state boundaries —

- nodal arrays (u, v, inc_u, inc_v, the lumped-mass diagonal) shard
  their dof axis across the mesh,
- qp arrays (strains, stresses, stiffness, history buffer) shard their
  qp axis (qp = cell * n_qp_per_cell + q, so this is a cell
  decomposition exactly like the reference's subdomain ownership,
  FE_problem.h:104-109),

and GSPMD partitions the gather -> einsum -> segment-sum assembly
between them, inserting the all-gather of displacements (the "ghost
exchange") and the reduce-scatter of force contributions (the "owned-
node accumulation") that an MPI FE code writes by hand.  Persistent
state memory per device drops to 1/n_devices of both node and qp
state, which is what breaks the ~1e7-node replication ceiling.

Numerically the sharded step computes the same sums in a different
reduction order, so agreement with the unsharded step is to roundoff
(tested at 1e-9 relative over multi-step runs), not bit-exact.

Usage::

    mesh = make_mesh(8)                      # ("md",) device mesh
    hmm = build_hooke_hmm(cfg)
    step = make_sharded_step(hmm, mesh)      # drop-in for hmm.step
    state = shard_fe_state(hmm.init_state(), mesh)
    state, out = jax.jit(step)(state)
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .state import FEState


def _spec_for(shape, mesh: Mesh, axis: str):
    """Leading-axis sharding when divisible, replication otherwise.

    jax requires named shardings to divide the dimension exactly; a
    non-divisible leaf (e.g. a 108-dof mesh on 8 devices) falls back to
    replication rather than erroring — the caller picks mesh sizes that
    divide when the memory posture matters.
    """
    n_dev = mesh.shape[axis]
    if len(shape) == 0 or shape[0] % n_dev != 0:
        return P()
    return P(axis, *([None] * (len(shape) - 1)))


def _constrain_tree(tree, mesh: Mesh, axis: str):
    def c(x):
        if not hasattr(x, "ndim"):
            return x
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, _spec_for(x.shape, mesh, axis)))

    return jax.tree_util.tree_map(c, tree)


def _constrain_state(state: FEState, mesh: Mesh, axis: str) -> FEState:
    """Sharding constraints on every FE state leaf.

    Nodal (n_dofs,) and qp (n_qp, ...) arrays both shard their leading
    axis; the scalar timestep/time/count leaves stay replicated.
    """
    return FEState(
        u=_constrain_tree(state.u, mesh, axis),
        v=_constrain_tree(state.v, mesh, axis),
        inc_u=_constrain_tree(state.inc_u, mesh, axis),
        inc_v=_constrain_tree(state.inc_v, mesh, axis),
        qp=_constrain_tree(state.qp, mesh, axis),
        hist=state.hist._replace(
            buffer=_constrain_tree(state.hist.buffer, mesh, axis),
            id_to_get_results_from=_constrain_tree(
                state.hist.id_to_get_results_from, mesh, axis),
            most_recent_id=_constrain_tree(
                state.hist.most_recent_id, mesh, axis),
        ),
        timestep=state.timestep,
        time=state.time,
    )


def shard_fe_state(state: FEState, mesh: Mesh, axis: str = "md") -> FEState:
    """device_put the persistent state with sharded layouts (so the
    memory win applies from step 0, not after the first jit)."""

    def put(x):
        if not hasattr(x, "ndim"):
            return x
        return jax.device_put(
            x, NamedSharding(mesh, _spec_for(x.shape, mesh, axis)))

    return jax.tree_util.tree_map(put, state)


def make_sharded_step(hmm, mesh: Mesh, axis: str = "md"):
    """Wrap ``hmm.step`` with FE-state sharding constraints.

    The constraints pin the *state boundaries*; GSPMD propagates through
    the step body (assembly, diagonal solve, strain update, history
    append, stress update) and inserts the collectives.  Works for any
    HMMProblem whose md_update_fn is either unsharded (GSPMD partitions
    it too) or already shard_mapped over the same mesh axis
    (mesh_utils.shard_md_update — the specs compose at the call
    boundary).
    """

    def step(state: FEState):
        state = _constrain_state(state, mesh, axis)
        state, out = hmm.step(state)
        return _constrain_state(state, mesh, axis), out

    return step
