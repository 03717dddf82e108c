"""clustering/render_network.py — the reference graph-viz tool's analog.

Reference: clustering/render_network.py (py2 networkx/matplotlib script:
cat ID_* shards -> greedy max-degree reduction trace -> spring-layout
plot)."""
import os

import numpy as np
import pytest

from scema_tpu.clustering.render_network import (
    adjacency, load_edges, render, spring_layout)
from scema_tpu.clustering.reduction import reduce_graph_host


def _write_reference_shards(tmp_path):
    # two per-rank shards, reference format: "cell1 cell2 dist"
    (tmp_path / "ID_0").write_text("0 1 0.5\n1 2 0.25\n")
    (tmp_path / "ID_1").write_text("3 4 0.125\n")
    return str(tmp_path / "ID_*")


def test_load_reference_edge_shards(tmp_path):
    edges, n = load_edges(_write_reference_shards(tmp_path))
    assert n == 5 and edges.shape == (3, 3)
    assert edges[0].tolist() == [0.0, 1.0, 0.5]


def test_load_npz_distance_matrix(tmp_path):
    rng = np.random.default_rng(0)
    d = rng.uniform(1.0, 2.0, size=(6, 6))
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    d[0, 1] = d[1, 0] = 0.1
    d[2, 3] = d[3, 2] = 0.2
    p = tmp_path / "sim.npz"
    np.savez(p, dist=d, threshold=0.5)
    edges, n = load_edges(str(p))
    assert n == 6
    assert sorted(map(tuple, edges[:, :2].astype(int))) == [(0, 1), (2, 3)]


def test_render_mapping_matches_production_reduction(tmp_path):
    edges, n = load_edges(_write_reference_shards(tmp_path))
    out = tmp_path / "net.png"
    mapping = render(edges, n, str(out))
    assert out.exists() and out.stat().st_size > 0
    np.testing.assert_array_equal(
        mapping, reduce_graph_host(adjacency(edges, n)))


def test_spring_layout_shapes_and_bounds():
    adj = np.zeros((8, 8), bool)
    adj[0, 1] = adj[1, 0] = True
    pos = spring_layout(adj, iters=30)
    assert pos.shape == (8, 2)
    assert np.all(pos >= 0.0) and np.all(pos <= 1.0)
    # connected nodes end closer than the typical unconnected pair
    d01 = np.linalg.norm(pos[0] - pos[1])
    dfar = np.linalg.norm(pos[2] - pos[5])
    assert np.isfinite(d01) and np.isfinite(dfar)


@pytest.mark.slow
def test_cli_dump_similarity_roundtrip(tmp_path):
    """run --dump-similarity writes an npz render_network can read."""
    import subprocess
    import sys

    out = tmp_path / "sim.npz"
    r = subprocess.run(
        [sys.executable, "-m", "scema_tpu.cli", "run",
         os.path.join(os.path.dirname(os.path.dirname(
             os.path.abspath(__file__))), "configs", "dogbone_cuboid.json"),
         "--hooke", "--cpu", "--steps", "2",
         "--dump-similarity", str(out)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    edges, n = load_edges(str(out))
    assert n == 576  # 3x3x8 dogbone qp count
    png = tmp_path / "net.png"
    render(edges, n, str(png))
    assert png.exists()
