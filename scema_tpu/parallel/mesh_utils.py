"""Device-mesh helpers: sharding the MD batch and qp arrays over devices.

Replaces the reference's MPI process-group composition (SURVEY.md section
2.8): the batch scheduler that split the MMD communicator into
``n_md_batches`` and round-robined jobs (stmd_sync.h:189-278, 570-618)
becomes a ``shard_map`` of the batched MD/bridging kernel over a named mesh
axis; the Gatherv/Bcast scale-bridging collectives (FE_problem.h:1381-1467,
dealammps.cc:406-415) disappear because FE and MD states share device
memory.

Conventions:
* axis ``"md"`` — the MD-job / quadrature-point batch axis (the reference's
  P3 task parallelism + P5 replica parallelism fold into it);
* FE nodal arrays stay replicated (the explicit diagonal solve is cheap);
  qp arrays are sharded on ``"md"``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_mesh(n_devices: int | None = None, axis: str = "md") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devs), (axis,))


def pad_to_multiple(x: jax.Array, m: int, axis: int = 0, fill=0):
    n = x.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return jnp.pad(x, pad, constant_values=fill), n


def shard_pairwise_l2(mesh: Mesh, axis: str = "md"):
    """Sharded pairwise-L2 kernel: the device-mesh analog of the reference's
    ring all-to-all strain-history comparison (strain2spline.h:546-614).

    Histories are sharded over qps; each device all_gathers the spline set
    (one collective — the ring) and computes its row block of the
    distance matrix.  Returns a function (splines (n, d)) -> (n, n).
    """
    n_dev = mesh.shape[axis]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=P(axis),
        check_vma=False,
    )
    def _dist(local):  # (n/n_dev, d)
        full = jax.lax.all_gather(local, axis, tiled=True)  # (n, d)
        diff = local[:, None, :] - full[None, :, :]
        return jnp.sqrt(jnp.sum(diff * diff, axis=-1))  # (n/n_dev, n)

    def wrapped(splines):
        padded, n = pad_to_multiple(splines, n_dev)
        out = _dist(padded)
        return out[:n, :n]

    return wrapped


def shard_md_update(md_update_fn, mesh: Mesh, axis=None):
    """Wrap a dense per-qp md_update_fn so it runs sharded over the mesh.

    Each device computes the update for its contiguous block of quadrature
    points (the reference's round-robin job->batch assignment,
    stmd_sync.h:583, becomes a block distribution).  The result is
    all-gathered because the downstream dedup gather
    (``update_stress_cg[id_to_get]``) may cross blocks.  The qp axis spans
    all mesh axes by default.
    """
    axis = tuple(mesh.axis_names) if axis is None else axis
    n_dev = mesh.size

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(None),
        check_vma=False,
    )
    def _sharded(eps_cg, material, jobs, most_recent_id):
        local = md_update_fn(eps_cg, material, jobs, most_recent_id)
        return jax.lax.all_gather(local, axis, tiled=True)

    def wrapped(eps_cg, material, jobs, most_recent_id):
        (eps_p, n) = pad_to_multiple(eps_cg, n_dev)
        mat_p, _ = pad_to_multiple(material, n_dev)
        jobs_p, _ = pad_to_multiple(jobs, n_dev)
        mri_p, _ = pad_to_multiple(most_recent_id, n_dev)
        out = _sharded(eps_p, mat_p, jobs_p, mri_p)
        return out[:n]

    return wrapped
