"""OPLS polymer material through the full HMM (the 'dogbone OPLS' path)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scema_tpu.config import HMMConfig
from scema_tpu.md import material as M
from scema_tpu.md import engine as E
from scema_tpu.md.homogenization import MDParams
from scema_tpu.hmm.md_coupling import build_md_hmm

# single-CPU wall budget: this module is compile/run-heavy (>150 s);
# the fast tier keeps subsystem coverage through its cheaper siblings
pytestmark = pytest.mark.slow

# 27 chains x 4 beads => L ~ 15.3 A; cutoff 6 + skin 1 respects the
# minimum-image bound (r_list <= L/2) that build_system now asserts
SPEC = M.MaterialSpec(name="g0", force_field="opls", n_chains=27, chain_length=4,
                      opls_lj_cutoff=6.0, opls_coul_cutoff=6.0, neighbor_k=48)


def test_opls_melt_material_builds_and_equilibrates():
    params = MDParams(temperature=100.0, dt=1.0, strain_rate=1e-3, nsteps_sample=20)
    sys, st = M.build_system(SPEC)
    assert sys.n_atoms == 27 * 4
    st = M.equilibrate(sys, st, params, jax.random.PRNGKey(0),
                       minimize_steps=100, equil_steps=50)
    assert np.isfinite(np.asarray(st.pos)).all()
    data = M.measure(sys, st, params)
    assert np.isfinite(data.stiff).all()
    assert data.density > 100.0  # a condensed-phase-ish box
    # bonds survived equilibration
    from scema_tpu.md import data_io

    melt = data_io.build_alkane_melt(27, 4)
    dr = np.asarray(st.pos)[melt.bonds[:, 1]] - np.asarray(st.pos)[melt.bonds[:, 0]]
    # chains may cross the periodic boundary: min-image the bond vectors
    L = melt.box[0, 0]
    dr -= np.round(dr / L) * L
    r = np.linalg.norm(dr, axis=1)
    assert r.max() < 2.2  # no broken bonds (r0 = 1.54)


def test_opls_dogbone_hmm_step():
    cfg = HMMConfig()
    cfg = cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=1),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=2),
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=False),
        material=cfg.material.__class__(number_of_replicas=1, materials=("g0",),
                                        proportions=(1.0,)),
        md=cfg.md.__class__(temperature=100.0, timestep_length=1.0,
                            strain_rate=1.0e-3, nsteps_sample=10,
                            force_field="opls"),
        md_dtype="float64",
    )
    hmm = build_md_hmm(cfg, spec=SPEC, equil_steps=30, minimize_steps=80)
    carry = hmm.init_state()
    carry, out = jax.jit(hmm.step)(carry)
    fe, (micro,) = carry
    assert int(out.n_jobs) == hmm.geom.n_qp_total
    sig = np.asarray(fe.qp.new_stress)
    assert np.isfinite(sig).all()
    assert np.abs(sig).max() > 0


def test_staged_melt_density_plausible():
    """The reference's in.init.lammps heatup/cooldown NPT prep settles the
    default octane melt at a literature-plausible density (~0.70 g/cm3 for
    united-atom C8 at 300 K, 1 atm; VERDICT round-1 item 7)."""
    params = MDParams(temperature=300.0, dt=2.0, strain_rate=1e-4,
                      nsteps_sample=40)
    spec = M.MaterialSpec(name="g0", force_field="opls")
    sys, st = M.build_system(spec, dtype=jnp.float32)
    st = M.equilibrate_staged(sys, st, params, jax.random.PRNGKey(1),
                              ns_init=60, minimize_steps=80)
    assert np.isfinite(np.asarray(st.pos)).all()
    data = M.measure(sys, st, params)
    # kg/m^3: liquid octane 650-720; allow model/short-prep latitude
    assert 450.0 < data.density < 950.0, f"density {data.density} kg/m3"
