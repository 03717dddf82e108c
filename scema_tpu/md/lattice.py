"""Crystal builders for initial microstates and tests.

The reference ships pre-equilibrated LAMMPS binary restarts
(nanoscale_input/init.<mat>_<n>.bin) which are opaque; this rebuild
generates initial configurations directly (diamond Si for the sw example,
fcc for LJ tests) and equilibrates them with md/init_material.py.
"""
from __future__ import annotations

import numpy as np


def diamond(a0: float, nx: int, ny: int, nz: int) -> tuple[np.ndarray, np.ndarray]:
    """Diamond cubic lattice (Si): returns (pos (N,3), h (3,3))."""
    basis = np.array(
        [
            [0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5],
            [0.25, 0.25, 0.25], [0.75, 0.75, 0.25], [0.75, 0.25, 0.75], [0.25, 0.75, 0.75],
        ]
    )
    cells = np.array(
        [[i, j, k] for i in range(nx) for j in range(ny) for k in range(nz)],
        dtype=float,
    )
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a0
    h = np.diag([a0 * nx, a0 * ny, a0 * nz])
    return pos, h


def fcc(a0: float, nx: int, ny: int, nz: int) -> tuple[np.ndarray, np.ndarray]:
    basis = np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
    )
    cells = np.array(
        [[i, j, k] for i in range(nx) for j in range(ny) for k in range(nz)],
        dtype=float,
    )
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a0
    h = np.diag([a0 * nx, a0 * ny, a0 * nz])
    return pos, h
