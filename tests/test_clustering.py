"""Clustering layer: splines vs scipy, distances, reduction vs networkx."""
import numpy as np
import jax
import jax.numpy as jnp
import networkx as nx
import pytest
from scipy.interpolate import CubicSpline

from scema_tpu.clustering.spline import splinify_histories
from scema_tpu.clustering.similarity import pairwise_l2, similarity_adjacency
from scema_tpu.clustering.reduction import reduce_graph, reduce_graph_host


def test_spline_matches_scipy_natural():
    rng = np.random.default_rng(0)
    n_steps, n_points = 37, 10
    cap = 64
    y = rng.standard_normal((2, n_steps, 6)).cumsum(axis=1) * 1e-3
    buf = np.zeros((2, cap, 6))
    buf[:, :n_steps] = y
    out = np.asarray(
        splinify_histories(jnp.asarray(buf), jnp.asarray(n_steps), n_points)
    ).reshape(2, n_points, 6)

    t_knots = np.arange(n_steps) / (n_steps - 1)
    t_eval = np.arange(n_points) / (n_points - 1)
    for q in range(2):
        for c in range(6):
            cs = CubicSpline(t_knots, y[q, :, c], bc_type="natural")
            assert np.allclose(out[q, :, c], cs(t_eval), atol=1e-12)


def test_spline_short_history_fallback():
    buf = np.zeros((1, 8, 6))
    buf[0, 0] = 1.0
    buf[0, 1] = 2.0
    out = np.asarray(splinify_histories(jnp.asarray(buf), jnp.asarray(2), 4))
    assert np.isfinite(out).all()


def test_pairwise_l2():
    rng = np.random.default_rng(1)
    s = rng.standard_normal((5, 60))
    d = np.asarray(pairwise_l2(jnp.asarray(s)))
    expect = np.sqrt(((s[:, None, :] - s[None, :, :]) ** 2).sum(-1))
    assert np.allclose(d, expect, atol=1e-10)


@pytest.mark.parametrize("n,block", [(300, 256), (513, 256), (70, 16)])
def test_pairwise_l2_blockwise_matches_direct(n, block):
    """Past one block the distances come from the padded blockwise map;
    they equal direct differencing, padding rows dropped."""
    rng = np.random.default_rng(n)
    s = rng.standard_normal((n, 10))
    d = np.asarray(pairwise_l2(jnp.asarray(s), block=block))
    expect = np.sqrt(((s[:, None, :] - s[None, :, :]) ** 2).sum(-1))
    assert d.shape == (n, n)
    assert np.allclose(d, expect, atol=1e-10)
    assert np.all(np.diag(d) == 0.0)


def _nx_reduce(adj):
    """The reference's algorithm verbatim via networkx
    (coarsegrain_dependency_network.py:46-90, lowest-id tie-break)."""
    n = adj.shape[0]
    G = nx.Graph()
    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j]:
                G.add_edge(i, j)
    mapping = list(range(n))
    while len(G) > 0:
        degs = dict(G.degree())
        maxdeg = max(degs.values())
        node = min(k for k, v in degs.items() if v == maxdeg)
        mapping[node] = node
        neigh = [node] + list(nx.all_neighbors(G, node))
        for m in neigh[1:]:
            mapping[m] = node
        G.remove_nodes_from(neigh)
    return np.asarray(mapping)


def test_reduce_graph_matches_networkx():
    rng = np.random.default_rng(2)
    for trial in range(5):
        n = 20
        adj = rng.random((n, n)) < 0.15
        adj = adj | adj.T
        np.fill_diagonal(adj, False)
        expect = _nx_reduce(adj)
        got_dev = np.asarray(reduce_graph(jnp.asarray(adj)))
        got_host = reduce_graph_host(adj)
        assert (got_dev == expect).all(), trial
        assert (got_host == expect).all(), trial


def test_reduce_graph_saturation_flag():
    """return_saturated is True only when an EDGE between two still-
    active nodes survives the pick cap (dedup actually truncated), not
    when leftover active nodes merely have zero live degree (their
    neighbors were consumed by earlier picks — identity mapping is the
    converged answer there)."""
    # star + pendant: one pick (node 0) consumes 1 and 2; node 3's only
    # edge went with 1 -> converged in one pick, must NOT report saturated
    adj = np.zeros((4, 4), bool)
    for a, b in [(0, 1), (0, 2), (1, 3)]:
        adj[a, b] = adj[b, a] = True
    m, sat = reduce_graph(jnp.asarray(adj), max_picks=1,
                          return_saturated=True)
    assert (np.asarray(m) == [0, 0, 0, 3]).all()
    assert not bool(sat)
    # two disjoint edges, one pick: edge (2, 3) remains -> truncated
    adj2 = np.zeros((4, 4), bool)
    for a, b in [(0, 1), (2, 3)]:
        adj2[a, b] = adj2[b, a] = True
    m2, sat2 = reduce_graph(jnp.asarray(adj2), max_picks=1,
                            return_saturated=True)
    assert bool(sat2)
    # with enough picks the same graph converges -> not saturated
    _, sat3 = reduce_graph(jnp.asarray(adj2), max_picks=4,
                           return_saturated=True)
    assert not bool(sat3)


def test_adjacency_respects_flags_and_threshold():
    s = jnp.asarray([[0.0] * 6, [1e-8] * 6, [1.0] * 6, [0.0] * 6])
    flagged = jnp.asarray([True, True, True, False])
    adj = np.asarray(similarity_adjacency(s, flagged, 1e-3))
    assert adj[0, 1] and adj[1, 0]
    assert not adj[0, 2]
    assert not adj[0, 3]  # qp 3 not flagged despite identical history
    assert not adj.diagonal().any()


def test_dedup_reduces_md_jobs_in_hmm():
    """Identical columns of qps under uniform strain: clustering should
    collapse MD jobs once active."""
    from scema_tpu.config import HMMConfig
    from scema_tpu.hmm.problem import build_hooke_hmm
    from scema_tpu.bridging import bridge

    cfg = HMMConfig()
    cfg = cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=2, y_cells=2, z_cells=2),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=20),
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=True),
        precision=cfg.precision.__class__(
            min_quadrature_strain_norm=1.0e-10,
            spline_points=10,
            clustering_min_steps=5,  # activate early
            clustering_diff_threshold=1.0e-2,  # generous: symmetric qps merge
        ),
    )
    hmm = build_hooke_hmm(cfg)
    state = hmm.init_state()
    step = jax.jit(hmm.step)
    jobs_before = jobs_after = None
    for k in range(8):
        state, out = step(state)
        if k == 3:
            jobs_before = int(out.n_jobs)  # timestep 4 <= min_steps: no dedup
        if k == 7:
            jobs_after = int(out.n_jobs)
    n_flagged = int(out.n_flagged)
    assert jobs_before is not None and jobs_before > 0
    # dedup active: strictly fewer MD jobs than flagged qps
    assert jobs_after < n_flagged
    # stress results still propagate to every flagged qp
    sig = np.asarray(state.qp.new_stress)
    assert np.abs(sig[:, 2]).max() > 0
