"""P4: spatial decomposition of ONE large MD box across the device mesh.

The reference runs each big LAMMPS job spatially decomposed over its batch
communicator (stmd_problem.h:156, 284 — LAMMPS's own domain decomposition
over MPI).  Here the cell grid's x-plane axis is sharded over the mesh's
"md" axis: each device owns a contiguous slab of cell planes, the
27-stencil's x±1 neighbors at slab boundaries arrive by a ring
``ppermute`` halo exchange (neighbour traffic only), and the total
energy is a ``psum``.  Forces come from ``jax.grad`` straight through the
``shard_map`` — the ppermute transposes to its inverse, so the halo
exchange differentiates for free.

Validated on the virtual CPU mesh: 8-way sharded energy/forces match the
single-device grid path at the 17.6k-atom SW example box
(tests/test_spatial_md.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..md import box as B


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShardedGridSpec:
    """Cell grid with the x-plane axis explicit (and shardable).

    Layout: slot grid (cap, c1, p_pad) — c1 x-planes, p_pad = padded
    c2*c3 in-plane cells (lane-aligned); the 9 in-plane (dy, dz) neighbor
    relations are static permutations of the p axis shared by every plane.
    """

    cells: tuple  # (c1, c2, c3)
    cap: int
    p_pad: int
    perms9: np.ndarray  # (9, p_pad) int32
    r_list: float


def derive_sharded_grid(n_atoms: int, h0: np.ndarray, cutoff: float,
                        skin: float = 0.5, n_shards: int = 1,
                        margin: float = 1.15) -> ShardedGridSpec:
    """Like grid.derive_grid but with c1 forced to a multiple of n_shards
    (>= 3 per shard is not required — halo exchange covers x±1)."""
    r = cutoff + skin
    L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]], dtype=float)
    nc = np.maximum(3, np.floor(L / (margin * r)).astype(int))
    c1 = int(nc[0]) // n_shards * n_shards
    if c1 < max(n_shards, 3):
        # c1 < 3 would alias the x-1 and x+1 stencil relations (pairs
        # double-counted); < n_shards cannot be slab-sharded at all
        raise ValueError(
            f"box too small to shard: {nc[0]} x-cells, need >= "
            f"max({n_shards}, 3)")
    c2, c3 = int(nc[1]), int(nc[2])
    Pc = c2 * c3
    p_pad = _round_up(max(Pc, 128), 128)
    density = n_atoms / float(np.prod(L))
    cellvol = float(L[0] / c1 * L[1] / c2 * L[2] / c3)
    cap = _round_up(int(np.ceil(density * cellvol * 2.0)) + 4, 8)

    idx = np.arange(Pc)
    iz = idx % c3
    iy = idx // c3
    perms9 = np.zeros((9, p_pad), dtype=np.int32)
    o = 0
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            ny = (iy + dy) % c2
            nz = (iz + dz) % c3
            perms9[o, :Pc] = ny * c3 + nz
            perms9[o, Pc:] = np.arange(Pc, p_pad)
            o += 1
    return ShardedGridSpec(cells=(c1, c2, c3), cap=cap, p_pad=p_pad,
                           perms9=perms9, r_list=r)


def bin_atoms(sg: ShardedGridSpec, pos: jax.Array, h: jax.Array) -> jax.Array:
    """Slot grid (cap, c1, p_pad) of atom ids (n = empty)."""
    n = pos.shape[0]
    c1, c2, c3 = sg.cells
    nc = jnp.asarray([c1, c2, c3])
    s = B.to_fractional(h, pos)
    s = s - jnp.floor(s)
    cxyz = jnp.clip((s * nc).astype(jnp.int32), 0, nc - 1)
    cid = (cxyz[:, 0] * c2 + cxyz[:, 1]) * c3 + cxyz[:, 2]  # x-major flat

    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    first = jnp.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = jnp.arange(n) - first
    # overflow atoms (rank >= cap) drop via the OOB scatter — clipping the
    # rank would race slot cap-1's occupant with unspecified ordering
    grid = jnp.full((sg.cap, c1 * c2 * c3), n, dtype=jnp.int32)
    grid = grid.at[rank, cid_sorted].set(
        order.astype(jnp.int32), mode="drop"
    )
    grid = grid.reshape(sg.cap, c1, c2 * c3)
    if sg.p_pad > c2 * c3:
        grid = jnp.pad(grid, ((0, 0), (0, 0), (0, sg.p_pad - c2 * c3)),
                       constant_values=n)
    return grid


# SW moment math shared with the single-device grid path — one
# implementation, two layouts (md/grid.py:sw_moment_block)


def sw_energy_sharded(sw, sg: ShardedGridSpec, mesh, pos, h,
                      axis: str = "md", grid_idx=None):
    """Total SW energy of one box, x-slab-sharded over ``mesh[axis]``.

    pos/h are replicated inputs; the slot grid is built once and sharded
    on its plane axis.  Each shard exchanges one boundary plane with each
    ring neighbor per force evaluation.  ``grid_idx`` reuses an existing
    binning (valid across a rebuild interval by the skin argument — and
    across affine deforms, which hold fractional coordinates fixed).
    """
    n = pos.shape[0]
    ndev = mesh.shape[axis]
    c1 = sg.cells[0]
    assert c1 % ndev == 0

    if grid_idx is None:
        grid_idx = bin_atoms(sg, pos, h)
    pos_pad = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)], axis=0)
    g = pos_pad[grid_idx.reshape(-1)].reshape(
        sg.cap, c1, sg.p_pad, 3)
    pos_g = jnp.transpose(g, (3, 0, 1, 2))  # (3, cap, c1, P)
    occ = (grid_idx < n).astype(pos.dtype)  # float: ppermute-friendly
    perms = jnp.asarray(sg.perms9)
    ih = B.inv_h(h)

    def local(pos_g_l, occ_l):
        # halo exchange: the plane axis is a ring over devices
        def halo(x, take_last):
            plane = x[..., -1:, :] if take_last else x[..., :1, :]
            src = [(i, (i + 1) % ndev) for i in range(ndev)] if take_last \
                else [((i + 1) % ndev, i) for i in range(ndev)]
            return jax.lax.ppermute(plane, axis, src)

        lo_p = halo(pos_g_l, True)   # left neighbor's last plane
        hi_p = halo(pos_g_l, False)  # right neighbor's first plane
        lo_o = halo(occ_l, True)
        hi_o = halo(occ_l, False)
        ext_p = jnp.concatenate([lo_p, pos_g_l, hi_p], axis=-2)
        ext_o = jnp.concatenate([lo_o, occ_l, hi_o], axis=-2)

        c1_loc = pos_g_l.shape[-2]
        cap = sg.cap
        flatC = c1_loc * sg.p_pad
        dt = pos.dtype
        own_p = pos_g_l.reshape(3, cap, flatC)
        own_o = occ_l.reshape(cap, flatC) > 0.5

        e2 = jnp.zeros((), dt)
        s_m = jnp.zeros((cap, flatC), dt)
        gsq_m = jnp.zeros((cap, flatC), dt)
        mvec = jnp.zeros((3, cap, flatC), dt)
        Q = jnp.zeros((3, 3, cap, flatC), dt)
        acc = (e2, s_m, gsq_m, mvec, Q)

        for dx in (-1, 0, 1):
            base_p = jax.lax.dynamic_slice_in_dim(ext_p, 1 + dx, c1_loc, -2)
            base_o = jax.lax.dynamic_slice_in_dim(ext_o, 1 + dx, c1_loc, -2)
            for o in range(9):
                npos = jnp.take(base_p, perms[o], axis=-1)
                nocc = jnp.take(base_o, perms[o], axis=-1) > 0.5
                npos = npos.reshape(3, cap, flatC)
                nocc = nocc.reshape(cap, flatC)
                dr = npos[:, None, :, :] - own_p[:, :, None, :]
                ds = jnp.einsum("ab,bijc->aijc", ih, dr)
                ds = ds - jnp.round(ds)
                drm = jnp.einsum("ab,bijc->aijc", jnp.asarray(h, dt), ds)
                r2 = jnp.sum(drm * drm, axis=0)
                mask = own_o[:, None, :] & nocc[None, :, :]
                if dx == 0 and o == 4:  # (0, 0, 0) relation: drop self
                    mask = mask & ~jnp.eye(cap, dtype=bool)[:, :, None]
                from ..md.grid import sw_moment_block

                acc = sw_moment_block(sw, drm, r2, mask, acc)

        from ..md.grid import sw_three_body_from_moments

        return jax.lax.psum(
            sw_three_body_from_moments(sw, acc, own_o), axis)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None, axis, None), P(None, axis, None)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(pos_g, occ)


def sw_forces_sharded(sw, sg: ShardedGridSpec, mesh, pos, h, axis="md",
                      grid_idx=None):
    """Forces = -grad of the sharded energy (halo exchange differentiates
    through the ppermute transpose)."""
    return -jax.grad(
        lambda p: sw_energy_sharded(sw, sg, mesh, p, h, axis=axis,
                                    grid_idx=grid_idx))(pos)


def sw_virial_sharded(sw, sg: ShardedGridSpec, mesh, pos, h, axis="md",
                      grid_idx=None):
    """Voigt-6 virial W = -dE/dF of the sharded energy (F the
    upper-triangular deformation applied to positions AND cell,
    fractionals held fixed — exact for any conservative energy)."""
    def e_of(f6):
        M = jnp.eye(3, dtype=pos.dtype) + jnp.array(
            [[f6[0], f6[3], f6[4]],
             [0.0, f6[1], f6[5]],
             [0.0, 0.0, f6[2]]], dtype=pos.dtype)
        return sw_energy_sharded(sw, sg, mesh, pos @ M.T, M @ h,
                                 axis=axis, grid_idx=grid_idx)

    return -jax.grad(e_of)(jnp.zeros(6, dtype=pos.dtype))


# --------------------------------------------------------------------------
# P4 sharded integration: the full strain/NVT/sampling time loop with the
# force work x-slab-decomposed across the mesh every step.


@dataclass(frozen=True)
class SpatialRunner:
    """MDSystem plug-in: when set, the engine
    run_strain/sample_stress loops run with sharded force evaluations.

    The reference runs each big MD job spatially decomposed over its
    batch communicator (stmd_problem.h:156, 284 — LAMMPS's MPI domain
    decomposition).  Here the state stays replicated (one box; O(N)
    integration is negligible) while the O(N * 27 * cap^2) stencil work
    is decomposed into x-slabs with one ppermute halo plane per ring
    neighbor per force call — the psum of force shards is the only
    collective over the device interconnect.
    """

    sg: ShardedGridSpec
    mesh: object
    axis: str = "md"


def run_strain_sharded(sys, runner: SpatialRunner, state, eps_eff,
                       n_steps, T, dt):
    """engine.run_strain semantics with sharded SW force evaluations:
    chunks of ``rebuild_every`` steps reuse one binning; fix-deform
    remaps positions affinely each step (fractionals fixed, so the
    binning stays valid across deform too)."""
    from ..md import engine as E

    sw = getattr(sys.ff, "sw", sys.ff)
    sg, mesh, axis = runner.sg, runner.mesh, runner.axis
    h0 = state.h
    n_steps = jnp.maximum(jnp.asarray(n_steps), sys.rebuild_every)
    n_chunks = n_steps // sys.rebuild_every
    dtype = state.pos.dtype
    eps = jnp.asarray(eps_eff, dtype)

    def chunk(c, st):
        grid_idx = bin_atoms(sg, st.pos, st.h)
        F = sw_forces_sharded(sw, sg, mesh, st.pos, st.h, axis=axis,
                              grid_idx=grid_idx)

        def inner(i, carry):
            st, F = carry
            st, F = E._verlet_step(
                sys, st, F, None, T, dt,
                forces_fn=lambda pos, h: sw_forces_sharded(
                    sw, sg, mesh, pos, h, axis=axis, grid_idx=grid_idx))
            gstep = c * sys.rebuild_every + i + 1
            frac = gstep.astype(dtype) / n_steps.astype(dtype)
            h_new = B.deform_path(h0, eps, frac)
            pos = B.remap_affine(st.h, h_new, st.pos)
            return (st._replace(pos=pos, h=h_new), F)

        st, _ = jax.lax.fori_loop(0, sys.rebuild_every, inner, (st, F))
        return st

    return jax.lax.fori_loop(0, n_chunks, chunk, state)


def sample_stress_sharded(sys, runner: SpatialRunner, state, n_steps,
                          T, dt):
    """engine.sample_stress semantics with sharded forces + virial."""
    from ..md import engine as E

    sw = getattr(sys.ff, "sw", sys.ff)
    sg, mesh, axis = runner.sg, runner.mesh, runner.axis
    dtype = state.pos.dtype
    R = sys.rebuild_every
    n_chunks = max(1, int(n_steps) // R)

    def chunk(carry, _):
        st = carry
        grid_idx = bin_atoms(sg, st.pos, st.h)
        F = sw_forces_sharded(sw, sg, mesh, st.pos, st.h, axis=axis,
                              grid_idx=grid_idx)

        def inner(i, c2):
            st, F, pacc = c2
            st, F = E._verlet_step(
                sys, st, F, None, T, dt,
                forces_fn=lambda pos, h: sw_forces_sharded(
                    sw, sg, mesh, pos, h, axis=axis, grid_idx=grid_idx))
            w6 = sw_virial_sharded(sw, sg, mesh, st.pos, st.h, axis=axis,
                                   grid_idx=grid_idx)
            W = jnp.array([[w6[0], w6[3], w6[4]],
                           [w6[3], w6[1], w6[5]],
                           [w6[4], w6[5], w6[2]]], dtype=dtype)
            p6 = E.pressure_tensor(sys, st, W)
            return (st, F, pacc + p6)

        st, _, pacc = jax.lax.fori_loop(
            0, R, inner, (st, F, jnp.zeros((6,), dtype)))
        return st, pacc

    st, accs = jax.lax.scan(chunk, state, None, length=n_chunks)
    press = jnp.sum(accs, axis=0) / (n_chunks * R)
    return st, press
