"""The XLA MD path that serves every backend: bonded forces, SHAKE/RATTLE
under straining, per-job step counts under vmap, padding job slots, and
the system build on an accelerator backend."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scema_tpu.config import HMMConfig
from scema_tpu.md import data_io as D
from scema_tpu.md import engine as E
from scema_tpu.md import material as M
from scema_tpu.md.forcefields import bonded as BD
from scema_tpu.md.homogenization import MDParams, strain_and_homogenize

# small charged all-atom PE melt with SHAKE on C-H bonds (the reference's
# lj/cut/coul + fix shake m 1.0 physics at a test-friendly size)
ALLATOM = dict(
    name="pe", force_field="opls", allatom=True, n_chains=4,
    chain_length=4, pe_density=0.33, opls_lj_cutoff=5.0,
    opls_coul_cutoff=4.5, validate=False, rebuild_every=10,
)
SW64 = M.MaterialSpec(name="si", force_field="sw", n_cells=2)


@pytest.mark.parametrize("layout", ["allatom_chain", "united_atom_melt"])
def test_bonded_forces_match_finite_difference(layout):
    """Autodiff bonded forces (bond + angle + OPLS dihedral) equal central
    finite differences of the bonded energy, on both topology layouts."""
    if layout == "allatom_chain":
        d = D.build_pe_chain_allatom(10)
        h = jnp.asarray(np.eye(3) * 100.0)
    else:
        d = D.build_alkane_melt(n_chains=8, n_carbons=8)
        h = jnp.asarray(d.box)
    ff = D.to_opls(d, use_ewald=False)
    rng = np.random.default_rng(3)
    pos = jnp.asarray(d.pos + 0.1 * rng.normal(size=d.pos.shape))

    def energy(p):
        return BD.bonded_energy(p, h, ff.topo, ff.bonded)

    F = np.asarray(-jax.grad(energy)(pos))
    eps = 1e-5
    picks = rng.choice(pos.shape[0], size=6, replace=False)
    for i in picks:
        for a in range(3):
            e_p = float(energy(pos.at[i, a].add(eps)))
            e_m = float(energy(pos.at[i, a].add(-eps)))
            fd = -(e_p - e_m) / (2 * eps)
            assert abs(F[i, a] - fd) < 1e-5 * max(1.0, abs(fd)), (i, a)


def test_shake_rattle_hold_allatom_bonds_through_strained_run():
    """SHAKE/RATTLE on the XLA path keep every C-H bond at its r0 and its
    bond-length rate at zero through a strained NVT run + sampling."""
    sys_, st = M.build_system(M.MaterialSpec(**ALLATOM))
    cons = sys_.constraints
    assert cons is not None and int(np.asarray(cons.mask).sum()) > 0
    st = E.minimize_fire(sys_, st, n_steps=200, dt0=0.25)
    st = st._replace(vel=E.maxwell_velocities(sys_, jax.random.PRNGKey(9),
                                              50.0))
    params = MDParams(temperature=50.0, dt=0.5, strain_rate=1e-3,
                      nsteps_sample=10)
    dl = jnp.asarray([0.01, -0.01, 0.02, 0.0, 0.004, 0.0])
    out, sig = jax.jit(lambda s: strain_and_homogenize(sys_, s, dl, params))(st)
    assert np.isfinite(np.asarray(sig)).all()

    i, j = np.asarray(cons.idx[:, 0]), np.asarray(cons.idx[:, 1])
    m = np.asarray(cons.mask)
    d = np.asarray(out.pos)[j] - np.asarray(out.pos)[i]
    r = np.linalg.norm(d, axis=1)
    assert np.abs(r - np.asarray(cons.d0))[m].max() < 1e-6
    dv = np.asarray(out.vel)[j] - np.asarray(out.vel)[i]
    rate = np.abs(np.sum(dv * d, axis=1))[m]
    assert rate.max() < 1e-6


def test_vmapped_jobs_with_traced_step_counts_match_separate_runs():
    """Jobs whose strains need different step counts (10 and 30 steps),
    batched under vmap with traced nts, reproduce their separate runs."""
    sys_, st = M.build_system(SW64)
    st = st._replace(vel=E.maxwell_velocities(sys_, jax.random.PRNGKey(0),
                                              50.0))
    params = MDParams(temperature=50.0, dt=1.0, strain_rate=1e-3,
                      nsteps_sample=10)
    L = float(st.h[0, 0])
    dls = jnp.asarray([[0.005 * L, 0, 0, 0, 0, 0],
                       [0.0, 0.025 * L, 0, 0, 0, 0]])
    run = jax.jit(lambda s, d: strain_and_homogenize(sys_, s, d, params))
    batched = jax.jit(jax.vmap(
        lambda d: strain_and_homogenize(sys_, st, d, params)))(dls)
    for k in range(2):
        out_k, sig_k = run(st, dls[k])
        pos_k = out_k.pos
        assert np.allclose(np.asarray(batched[0].pos[k]), np.asarray(pos_k),
                           atol=1e-10)
        assert np.allclose(np.asarray(batched[1][k]), np.asarray(sig_k),
                           rtol=1e-9, atol=1e-3)


def test_padding_slots_leave_unflagged_qps_untouched():
    """A job list with padding slots updates only the flagged qps: the
    others keep their microstate and get no stress, and a flagged qp's
    result does not depend on how many other slots run."""
    from scema_tpu.hmm.md_coupling import build_md_hmm

    cfg = HMMConfig()
    cfg = cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=1),
        bridging=cfg.bridging.__class__(stress_method=0,
                                        approx_md_with_hookes_law=False),
        md=cfg.md.__class__(temperature=0.01, timestep_length=0.05,
                            strain_rate=1.0e-2, nsteps_sample=10,
                            force_field="sw"),
        dtype="float64", md_dtype="float64",
    )
    hmm = build_md_hmm(cfg, spec=SW64, equil_steps=0, minimize_steps=10)
    be = hmm.backend
    n_qp = hmm.geom.n_qp_total
    assert be.max_jobs == n_qp == 8
    update = jax.jit(be.make_update_fn())
    micro = hmm._fresh_micro()[0]
    rng = np.random.default_rng(0)
    eps = jnp.asarray(1e-3 * rng.normal(size=(n_qp, 6)))
    material = jnp.zeros((n_qp,), jnp.int32)
    own = jnp.arange(n_qp, dtype=jnp.int32)

    def run(flagged):
        jobs = jnp.zeros((n_qp,), bool).at[jnp.asarray(flagged)].set(True)
        return update(micro, eps, material, jobs, own)

    m3, upd3, has3, _ = run([0, 2, 7])
    m1, upd1, has1, _ = run([2])
    assert np.array_equal(np.asarray(has3), np.isin(np.arange(n_qp), [0, 2, 7]))
    idle = ~np.asarray(has3)
    assert np.all(np.asarray(upd3)[idle] == 0.0)
    for new, old in ((m3.pos, micro.pos), (m3.vel, micro.vel),
                     (m3.h, micro.h)):
        assert np.array_equal(np.asarray(new)[idle], np.asarray(old)[idle])
    assert not np.asarray(m3.has_run)[idle].any()
    assert np.allclose(np.asarray(upd3)[2], np.asarray(upd1)[2],
                       rtol=1e-10, atol=1e-6)
    assert np.allclose(np.asarray(m3.pos)[2], np.asarray(m1.pos)[2],
                       atol=1e-12)


@pytest.mark.parametrize("spec", [
    M.MaterialSpec(name="lj", force_field="lj", n_cells=4, a0=5.26),
    M.MaterialSpec(**ALLATOM),
    SW64,
], ids=["lj", "opls", "sw"])
def test_build_system_on_gpu_backend_takes_xla_path(spec, monkeypatch):
    """On an accelerator backend the builder runs on the host CPU and the
    system it returns is the plain XLA one, identical to the CPU build."""
    sys_c, st_c = M.build_system(spec)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    sys_g, st_g = M.build_system(spec)
    assert type(sys_g.ff) is type(sys_c.ff)
    assert sys_g.nspec == sys_c.nspec
    assert np.array_equal(np.asarray(st_g.pos), np.asarray(st_c.pos))
    eps = jnp.asarray([1e-3, 0.0, -5e-4, 0.0, 0.0, 0.0])
    outs = [jax.jit(lambda s, _s=s_: E.run_strain(_s, s, eps, jnp.asarray(10),
                                                  10.0, 0.5))(st)
            for s_, st in ((sys_c, st_c), (sys_g, st_g))]
    assert np.isfinite(np.asarray(outs[1].pos)).all()
    assert np.allclose(np.asarray(outs[0].pos), np.asarray(outs[1].pos),
                       atol=1e-12)
