"""End-to-end HMM tests in Hooke debug mode (the reference's key testing
affordance, SURVEY.md section 4.1) plus cross-checks between stress methods.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from scema_tpu.config import HMMConfig, config_from_dict
from scema_tpu.hmm.problem import build_hooke_hmm
from scema_tpu.utils import tensors as T
from scema_tpu.bridging import bridge

E, NU, RHO = 3.0e9, 0.35, 1200.0


def make_cfg(**over):
    cfg = HMMConfig()
    cfg = cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=1),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=10),
        bridging=cfg.bridging.__class__(
            stress_method=0, approx_md_with_hookes_law=True, use_pjm_scheduler=False
        ),
        **over,
    )
    return cfg


def test_single_cell_dogbone_hooke_exact():
    """All dofs of a 1-cell dogbone are constrained -> closed-form response.

    Per step the top face moves by strain_rate * Lz (dogbone.h:136-143 with
    the velocity integration of FE_problem.h:1021-1037), so after n steps
    eps_zz = n * strain_rate under uniaxial-strain conditions and
    sigma_zz = (lam + 2 mu) eps_zz, sigma_xx = lam eps_zz.
    """
    cfg = make_cfg()
    hmm = build_hooke_hmm(cfg)
    state = hmm.init_state()
    step = jax.jit(hmm.step)
    n = 5
    for _ in range(n):
        state, out = step(state)

    sr = cfg.problem.strain_rate
    lam = E * NU / ((1 + NU) * (1 - 2 * NU))
    mu = E / (2 * (1 + NU))
    eps = np.asarray(state.qp.new_strain)
    sig = np.asarray(state.qp.new_stress)

    assert np.allclose(eps[:, 2], n * sr, rtol=1e-12)
    assert np.allclose(eps[:, 0], 0.0, atol=1e-15)
    assert np.allclose(sig[:, 2], (lam + 2 * mu) * n * sr, rtol=1e-9)
    assert np.allclose(sig[:, 0], lam * n * sr, rtol=1e-9)
    assert np.allclose(sig[:, 3:], 0.0, atol=1e-4)

    # top-face displacement: u_z = n * strain_rate * Lz
    u = np.asarray(state.u).reshape(-1, 3)
    top = np.asarray(hmm.problem.mesh.nodes[:, 2]) > 0.08 - 1e-9
    assert np.allclose(u[top, 2], n * sr * 0.08, rtol=1e-12)


def test_example_displacement_milestone():
    """The shipped integration example reports max displacement 0.32 mm at
    timestep 2 (examples/streched_polyhedron/README.md): 2 * 0.002 * 0.08."""
    cfg = make_cfg()
    cfg = cfg.replace(mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2))
    hmm = build_hooke_hmm(cfg)
    state = hmm.init_state()
    step = jax.jit(hmm.step)
    for _ in range(2):
        state, _ = step(state)
    u = np.asarray(state.u).reshape(-1, 3)
    assert np.isclose(np.abs(u).max(), 0.32e-3, rtol=1e-10)


def test_method0_hooke_matches_method1_tangent():
    """Hooke fake-MD via the full bridging path == direct tangent update.

    With identity orientations, updating every qp every step, the bridged
    sigma += C:upd_strain must equal method 1's sigma += C:newton_strain.
    Validates job packing, rotations, replica averaging, scatter-back.
    """
    cfg0 = make_cfg()
    cfg0 = cfg0.replace(mesh=cfg0.mesh.__class__(x_cells=2, y_cells=2, z_cells=4))
    hmm0 = build_hooke_hmm(cfg0)

    cfg1 = cfg0.replace(bridging=cfg0.bridging.__class__(stress_method=1))
    hmm1 = build_hooke_hmm(cfg1)

    s0, s1 = hmm0.init_state(), hmm1.init_state()
    step0, step1 = jax.jit(hmm0.step), jax.jit(hmm1.step)
    for _ in range(6):
        s0, o0 = step0(s0)
        s1, o1 = step1(s1)

    sig0, sig1 = np.asarray(s0.qp.new_stress), np.asarray(s1.qp.new_stress)
    scale = np.abs(sig1).max()
    assert np.allclose(sig0, sig1, atol=1e-9 * scale)
    u0, u1 = np.asarray(s0.u), np.asarray(s1.u)
    assert np.allclose(u0, u1, atol=1e-9 * np.abs(u1).max())


def test_replica_rotation_averaging_isotropic_invariance():
    """Rotated replicas of an isotropic material must average to the same
    stress as identity replicas (rotation/averaging plumbing check,
    stmd_sync.h:878-922)."""
    cfg = make_cfg()
    n_mat, n_repl = 1, 3
    stiff = T.isotropic_c66(E, NU)
    vecs = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0.6, 0, 0.8]])
    cg = jnp.asarray([1.0, 0, 0])
    rots = jnp.stack([T.compute_rotation_tensor(v, cg) for v in vecs])[None]
    ens = bridge.ReplicaEnsemble(
        rotam=rots,
        init_length=jnp.ones((n_mat, n_repl, 3)),
        init_stress=jnp.zeros((n_mat, n_repl, 6)),
        init_stiff=jnp.broadcast_to(stiff, (n_mat, n_repl, 6, 6)),
        rho=jnp.full((n_mat, n_repl), RHO),
    )
    eps = jnp.asarray([[1e-3, -2e-4, 3e-4, 1e-4, 0.0, -5e-5]])
    mat = jnp.zeros((1,), dtype=jnp.int32)
    got = np.asarray(bridge.hooke_update_stress(ens, eps, mat))
    expect = np.asarray(T.sym_contract_c66(stiff, eps))
    assert np.allclose(got, expect, rtol=1e-8)


def test_dogbone_config_loads():
    """The in-repo dogbone config (reference schema) parses unchanged."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "dogbone_cuboid.json")
    with open(path) as f:
        d = json.load(f)
    cfg = config_from_dict(d)
    assert cfg.problem.cls == "dogbone"
    assert cfg.mesh.z_cells == 8
    assert cfg.md.temperature == 300.0
    assert cfg.precision.spline_points == 10
    hmm = build_hooke_hmm(cfg.replace(
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=True)
    ))
    assert hmm.geom.n_qp_total == 3 * 3 * 8 * 8
