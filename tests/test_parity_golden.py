"""The 1e-6 parity artifact: Hooke-mode dogbone cuboid (configs/
dogbone_cuboid.json, the reference's inputs_dogbone_cuboid settings),
10 macro-steps, full 576-qp stress field checked against an independently
derived golden solution.

The golden field comes from tests/twin_fe.py — a pure-numpy explicit-
dynamics FE implementation written from the reference's discrete
formulation (FE_problem.h:1021-1037, 1631-1752, 2400-2502) that shares no
code, mesh numbering, or shape-function evaluation with scema_tpu.
Quadrature points are matched by physical coordinates.  A committed npz
snapshot (tests/golden/dogbone_hooke_10step.npz) pins the values so the
framework and the twin cannot drift together unnoticed.
"""
import os

import numpy as np
import jax

from scema_tpu.config import load_config
from scema_tpu.hmm.problem import build_hooke_hmm

from twin_fe import run_dogbone_twin

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(os.path.dirname(HERE), "configs", "dogbone_cuboid.json")
GOLDEN = os.path.join(HERE, "golden", "dogbone_hooke_10step.npz")
N_STEPS = 10


def _match_qps(a_xyz, b_xyz):
    """Index arrays mapping both qp sets into a canonical coordinate order."""
    def order(x):
        key = np.round(x / 1e-9).astype(np.int64)
        return np.lexsort((key[:, 0], key[:, 1], key[:, 2]))

    ia, ib = order(a_xyz), order(b_xyz)
    assert np.allclose(a_xyz[ia], b_xyz[ib], atol=1e-9)
    return ia, ib


def _run_framework():
    cfg = load_config(CONFIG, dtype="float64")
    cfg = cfg.replace(
        bridging=cfg.bridging.__class__(
            stress_method=0, approx_md_with_hookes_law=True,
            use_pjm_scheduler=False,
        )
    )
    hmm = build_hooke_hmm(cfg)
    state = hmm.init_state()
    step = jax.jit(hmm.step)
    sig = []
    for _ in range(N_STEPS):
        state, _ = step(state)
        sig.append(np.asarray(state.qp.new_stress))
    # physical qp coordinates for matching
    g = hmm.geom
    import jax.numpy as jnp

    nodes = jnp.asarray(hmm.problem.mesh.nodes)
    qp_xyz = jnp.einsum("qv,cvi->cqi", g.shapes, nodes[g.cells])
    return (
        np.stack(sig),  # (n_steps, n_qp, 6)
        np.asarray(qp_xyz).reshape(-1, 3),
        np.asarray(state.u).reshape(-1, 3),
        hmm.problem.mesh.nodes,
    )


def test_stress_field_matches_independent_twin_1e6():
    sig_fw, xyz_fw, u_fw, nodes_fw = _run_framework()
    twin = run_dogbone_twin(N_STEPS)
    sig_tw = twin["sigma"].reshape(N_STEPS, -1, 6)
    xyz_tw = twin["qp_xyz"].reshape(-1, 3)

    ia, ib = _match_qps(xyz_fw, xyz_tw)
    a = sig_fw[:, ia, :]
    b = sig_tw[:, ib, :]
    scale = np.abs(b).max()
    err = np.abs(a - b).max() / scale
    assert err < 1e-6, f"stress-field parity {err:.3e} vs twin (scale {scale:.3e})"

    # displacement field too (matched by node coordinates)
    na, nb = _match_qps(nodes_fw, twin["nodes"])
    u_tw = twin["u"][-1].reshape(-1, 3)
    du = np.abs(u_fw[na] - u_tw[nb]).max()
    assert du / np.abs(u_tw).max() < 1e-6


def test_stress_field_matches_committed_golden():
    """Pin against the committed snapshot so twin+framework can't co-drift."""
    assert os.path.exists(GOLDEN), (
        "golden snapshot missing — regenerate with "
        "python tests/make_golden.py"
    )
    d = np.load(GOLDEN)
    sig_fw, xyz_fw, _, _ = _run_framework()
    ia, ib = _match_qps(xyz_fw, d["qp_xyz"])
    a = sig_fw[:, ia, :]
    b = d["sigma"][:, ib, :]
    scale = np.abs(b).max()
    assert np.abs(a - b).max() / scale < 1e-6
