"""VTK/CSV writers and checkpoint round-trips."""
import os

import numpy as np
import jax
import pytest

from scema_tpu.config import HMMConfig
from scema_tpu.hmm.problem import build_hooke_hmm
from scema_tpu.hmm.checkpoint import save_checkpoint, load_checkpoint
from scema_tpu.fem.output import OutputWriter, write_vtu, write_pvd


def small_hmm():
    cfg = HMMConfig()
    cfg = cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=10),
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=True),
    )
    return build_hooke_hmm(cfg)


def test_vtu_well_formed(tmp_path):
    import xml.etree.ElementTree as ET

    hmm = small_hmm()
    state = hmm.init_state()
    state, out = jax.jit(hmm.step)(state)
    w = OutputWriter(str(tmp_path), hmm.problem.mesh.nodes, hmm.problem.mesh.cells)
    fname = w.write_visualisation(state, 1, 5e-7)
    tree = ET.parse(tmp_path / fname)
    piece = tree.getroot().find(".//Piece")
    assert piece.get("NumberOfPoints") == str(hmm.problem.mesh.n_nodes)
    assert piece.get("NumberOfCells") == "2"
    names = [d.get("Name") for d in tree.getroot().findall(".//PointData/DataArray")]
    assert "displacement" in names and "velocity" in names
    cnames = [d.get("Name") for d in tree.getroot().findall(".//CellData/DataArray")]
    assert {"strain", "stress", "material", "von_mises"} <= set(cnames)
    # pvd master exists and references the per-step pvtu collection,
    # which in turn references the vtu piece (the reference's layout)
    assert (tmp_path / "solution.pvd").exists()
    pvd = (tmp_path / "solution.pvd").read_text()
    assert fname.replace(".vtu", ".pvtu") in pvd
    assert fname in (tmp_path / fname.replace(".vtu", ".pvtu")).read_text()


def test_history_projection_exact_on_linear_field(tmp_path):
    """The DG qp->node projection (FE_problem.h:1863-1937) must recover a
    field that is (tri)linear in space EXACTLY at the cell nodes — the
    2x2x2 Gauss rule has as many points as DG-Q1 dofs, so the L2
    projection is interpolation-exact on the Q1 space."""
    from scema_tpu.fem.output import project_history_to_nodes
    from scema_tpu.fem import shapes as S

    hmm = small_hmm()
    nodes = np.asarray(hmm.problem.mesh.nodes)
    cells = np.asarray(hmm.problem.mesh.cells)
    geom = hmm.geom
    n_cells = len(cells)
    n_qp = geom.n_qp_per_cell
    # qp real-space coordinates: x_q = sum_i phi_i(xi_q) x_i
    shp = np.asarray(geom.shapes)  # (n_qp, 8)
    xq = np.einsum("qi,cik->cqk", shp, nodes[cells])  # (n_cells, n_qp, 3)

    def lin(p):  # a full trilinear-compatible affine field, 6 components
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return np.stack([1.0 + 2 * x, 3 * y - z, x + y + z,
                         0.5 - x + 4 * z, 2 * z, -y], axis=-1)

    qp_field = lin(xq).reshape(n_cells * n_qp, 6)
    nodal = project_history_to_nodes(qp_field, n_cells)  # (n_cells*8, 6)
    expect = lin(nodes[cells].reshape(-1, 3))
    np.testing.assert_allclose(nodal, expect, rtol=0, atol=1e-12)


def test_history_vtu_well_formed(tmp_path):
    import xml.etree.ElementTree as ET

    hmm = small_hmm()
    state = hmm.init_state()
    state, out = jax.jit(hmm.step)(state)
    w = OutputWriter(str(tmp_path), hmm.problem.mesh.nodes, hmm.problem.mesh.cells)
    fname = w.write_visualisation_history(state, 1, 5e-7)
    tree = ET.parse(tmp_path / fname)
    piece = tree.getroot().find(".//Piece")
    # discontinuous mesh: 8 private points per cell
    assert piece.get("NumberOfPoints") == str(2 * 8)
    assert piece.get("NumberOfCells") == "2"
    names = {d.get("Name") for d in tree.getroot().findall(".//PointData/DataArray")}
    want = {f"{t}_{c}" for t in ("strain", "stress")
            for c in ("xx", "yy", "zz", "xy", "xz", "yz")}
    assert want <= names  # FE_problem.h:2067-2073 component names
    assert (tmp_path / "history.pvd").exists()
    assert fname.replace(".vtu", ".pvtu") in (tmp_path / "history.pvd").read_text()


def test_csv_outputs(tmp_path):
    hmm = small_hmm()
    state = hmm.init_state()
    state, out = jax.jit(hmm.step)(state)
    w = OutputWriter(str(tmp_path), hmm.problem.mesh.nodes, hmm.problem.mesh.cells)
    w.write_lbc_force(1, 5e-7, float(out.reaction_force))
    p = w.write_lhistory(state, 1)
    lines = open(p).read().splitlines()
    assert len(lines) == 1 + hmm.geom.n_qp_total
    lbc = open(tmp_path / "loaded_boundary_force.csv").read().splitlines()
    assert len(lbc) == 2 and lbc[1].startswith("1,")


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """Checkpointed run resumes bit-identically."""
    hmm = small_hmm()
    step = jax.jit(hmm.step)

    s = hmm.init_state()
    for _ in range(3):
        s, _ = step(s)
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, s)

    # continue the original
    s_cont = s
    for _ in range(2):
        s_cont, _ = step(s_cont)

    # restore and continue
    s_rest = load_checkpoint(ckpt, hmm.init_state())
    assert int(s_rest.timestep) == 3
    for _ in range(2):
        s_rest, _ = step(s_rest)

    for a, b in zip(jax.tree_util.tree_leaves(s_cont), jax.tree_util.tree_leaves(s_rest)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------- reference lcts.* IO

def test_dealii_block_vector_roundtrip(tmp_path):
    """Byte-exact deal.II Vector::block_write format (FE_problem.h:2289)."""
    from scema_tpu.fem.reference_restart import (
        read_dealii_vector, write_dealii_vector,
    )

    v = np.linspace(-1.5, 2.5, 17)
    p = str(tmp_path / "lcts.solution.bin")
    write_dealii_vector(p, v)
    raw = open(p, "rb").read()
    assert raw.startswith(b"17\n[") and raw.endswith(b"]")
    assert len(raw) == len(b"17\n[") + 17 * 8 + 1
    got = read_dealii_vector(p)
    assert np.array_equal(got, v)


def test_lhistory_roundtrip(tmp_path):
    from scema_tpu.fem.reference_restart import read_lhistory, write_lhistory

    rng = np.random.default_rng(3)
    n_cells, nq = 2, 8
    upd = rng.normal(size=(n_cells * nq, 6))
    sig = rng.normal(size=(n_cells * nq, 6)) * 1e8
    mat = np.zeros(n_cells * nq, dtype=int)
    write_lhistory(str(tmp_path / "lcts.pr_0.lhistory.bin"), 2.5e-6, mat,
                   upd, sig, nq)
    t, upd2, sig2 = read_lhistory(str(tmp_path), n_cells, nq)
    assert t == 2.5e-6
    assert np.allclose(upd2, upd, rtol=1e-14)
    assert np.allclose(sig2, sig, rtol=1e-14)


def test_reference_restart_continuation(tmp_path):
    """Save a reference-format checkpoint mid-run, restore into a FRESH
    problem, continue — final stress field matches the uninterrupted run
    (the reference's own restart loses history splines and sticky flags,
    both inert here: clustering min_steps > n_steps, flags re-trigger at
    1e-10 immediately)."""
    from scema_tpu.fem.reference_restart import (
        save_reference_checkpoint, load_reference_restart,
    )
    import jax.numpy as jnp

    hmm = small_hmm()
    step = jax.jit(hmm.step)

    state = hmm.init_state()
    for _ in range(10):
        state, _ = step(state)
    sig_full = np.asarray(state.qp.new_stress)

    state = hmm.init_state()
    for _ in range(5):
        state, _ = step(state)
    save_reference_checkpoint(str(tmp_path), state, hmm.problem.mesh)

    hmm2 = small_hmm()
    s2 = hmm2.init_state()
    s2 = load_reference_restart(str(tmp_path), s2, hmm2.geom,
                                hmm2.problem.mesh)
    s2 = s2._replace(timestep=jnp.asarray(5, jnp.int32))
    for _ in range(5):
        s2, _ = step(s2)
    sig_resumed = np.asarray(s2.qp.new_stress)
    scale = np.abs(sig_full).max()
    assert np.abs(sig_resumed - sig_full).max() / scale < 1e-9


def test_pvtu_visit_masters_and_eps(tmp_path):
    """Parallel-collection masters + EPS mesh dump (FE_problem.h:2232-2253,
    168-179)."""
    hmm = small_hmm()
    state = hmm.init_state()
    state, out = jax.jit(hmm.step)(state)
    w = OutputWriter(str(tmp_path), hmm.problem.mesh.nodes,
                     hmm.problem.mesh.cells)
    w.write_visualisation(state, 1, 5e-7)
    assert (tmp_path / "solution-000001.pvtu").exists()
    visit = (tmp_path / "solution-000001.visit").read_text()
    assert visit.startswith("!NBLOCKS 1") and "solution-000001.vtu" in visit
    import xml.etree.ElementTree as ET

    tree = ET.parse(tmp_path / "solution-000001.pvtu")
    pieces = tree.getroot().findall(".//Piece")
    assert pieces[0].get("Source") == "solution-000001.vtu"
    # pvd references the pvtu master now
    assert "solution-000001.pvtu" in (tmp_path / "solution.pvd").read_text()

    eps = w.write_mesh_eps()
    txt = open(eps).read()
    assert txt.startswith("%!PS-Adobe") and "lineto" in txt


def test_mddata_csv_rows(tmp_path):
    from scema_tpu.fem.output import OutputWriter as OW

    w = OW(str(tmp_path), np.zeros((8, 3)), np.arange(8)[None, :])
    strain = np.arange(12, dtype=float).reshape(2, 6)
    stress = np.arange(24, dtype=float).reshape(2, 2, 6) * 1e6
    w.write_mddata(3, [0, 1], np.zeros(2, int), strain, stress,
                   300.0, 1e-4, "opls")
    p = tmp_path / "mddata_qpid1_repl2.csv"
    lines = p.read_text().splitlines()
    assert lines[0].startswith("qp_id,material_id,time_id,temperature,"
                               "strain_rate,force_field,replica_id,strain_00")
    row = lines[1].split(",")
    assert row[0] == "1" and row[6] == "2" and row[5] == "opls"
    # Voigt -> triu reorder: strain_01 column holds the Voigt xy component
    assert float(row[8]) == strain[1][3]
    # appending keeps a single header
    w.write_mddata(4, [1], np.zeros(2, int), strain, stress, 300.0, 1e-4,
                   "opls")
    assert len(p.read_text().splitlines()) == 3


def test_cli_fault_recovery(tmp_path, monkeypatch, capsys):
    """An injected device fault mid-run rolls back to the last good step
    and the run completes with the correct final state (the CLI's
    transient-fault retry; the reference can only exit(1) + restart)."""
    import json
    import types

    import jax as _jax
    from scema_tpu import cli as CLI

    cfg = {
        "problem type": {"class": "dogbone", "strain rate": 0.002},
        "scale-bridging": {"stress computation method": 0,
                           "approximate md with hookes law": 1},
        "continuum time": {"timestep length": 5e-07, "start timestep": 1,
                           "end timestep": 4},
        "continuum mesh": {"fe degree": 1, "quadrature formula": 2,
                          "input": {"style": "cuboid", "x length": 0.03,
                                    "y length": 0.03, "z length": 0.08,
                                    "x cells": 1, "y cells": 1,
                                    "z cells": 2}},
    }
    p = tmp_path / "inputs.json"
    p.write_text(json.dumps(cfg))

    real_jit = _jax.jit
    calls = {"n": 0}

    def faulty(run):
        def wrapper(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 3:  # fail once mid-run
                raise RuntimeError("injected device fault")
            return run(*args, **kwargs)

        return wrapper

    def faulty_jit(fn, *a, **kw):
        # the CLI compiles ahead of time (jit(...).lower(...).compile()),
        # so the fault rides on the compiled executable's calls
        jitted = real_jit(fn, *a, **kw)
        wrapper = faulty(jitted)
        wrapper.lower = lambda *la, **lk: types.SimpleNamespace(
            compile=lambda: faulty(jitted.lower(*la, **lk).compile()))
        return wrapper

    monkeypatch.setattr(CLI, "jax", _jax, raising=False)
    monkeypatch.setattr(_jax, "jit", faulty_jit)
    rc = CLI.main(["run", str(p), "--hooke", "--cpu", "--steps", "4"])
    monkeypatch.setattr(_jax, "jit", real_jit)
    assert rc == 0
    outerr = capsys.readouterr()
    assert "injected device fault" in outerr.err
    assert "rolling back" in outerr.err
    # 4 steps of the 1x1x2 dogbone: 4 * 0.002 * 0.08 = 0.64 mm
    assert "Max displacement: 0.00064" in outerr.out
