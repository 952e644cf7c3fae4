"""Spiral/ring deposition schedules as precomputed activation-time arrays.

Design: instead of the reference's host-side arc-marking loop
(``mark_arc_on_layer``, quick_spiral_deposition_gif_v5.py:192-215, and its
copy in tests/test_spiral_vs_analytic.py:59-77), the whole deposition
kinematics is precomputed into one ``activation_time[nphi, nz]`` array.  The
active mask at any time t is then the pure elementwise expression
``activation_time < t`` and newborn cells between two step times are
``(t_prev <= activation_time) & (activation_time < t_next)`` — data, not
control flow, so the jitted time loop never retraces on birth events.

Kinematics (loops_per_layer = q, nozzle angular speed omega = 2*pi/tau_dep):
layer L occupies z-cells [iz_base + L*layer_cells, ...); its phi-column i
activates the first time the nozzle arc touches the cell, which happens at
angle i*dphi of the layer's first loop:
``t_activate(i, L) = (L*q + i/nphi) * tau_dep``  (column 0 at layer start).
This reproduces the reference's cell-marking semantics: a cell is marked when
the swept arc (a0, a1] satisfies a1 > i*dphi.
"""
from __future__ import annotations

import jax
import numpy as np

from ..core.grid import CylindricalGrid

__all__ = ["spiral_activation_times", "ring_activation_times", "active_at",
           "newborn_between"]


def spiral_activation_times(grid: CylindricalGrid, *, iz_base: int,
                            layer_cells: int, n_layers: int,
                            tau_dep: float, loops_per_layer: int = 1,
                            dtype=np.float64) -> np.ndarray:
    """(nphi, nz) activation times; substrate rows (iz < iz_base) are -inf and
    never-deposited rows are +inf."""
    nphi, nz = grid.nphi, grid.nz
    act = np.full((nphi, nz), np.inf, dtype=dtype)
    act[:, :iz_base] = -np.inf
    col = np.arange(nphi, dtype=dtype) / nphi  # fraction of a loop
    for layer in range(n_layers):
        t0 = layer * loops_per_layer * tau_dep
        iz0 = iz_base + layer * layer_cells
        iz1 = min(iz0 + layer_cells, nz)
        if iz0 >= nz:
            break
        act[:, iz0:iz1] = (t0 + col * tau_dep)[:, None]
    return act


def ring_activation_times(grid: CylindricalGrid, *, iz_base: int,
                          layer_cells: int, n_layers: int,
                          tau_per_layer: float,
                          dtype=np.float64) -> np.ndarray:
    """(nphi, nz) activation times for instant full-ring layers: layer L's
    cells all activate at ``L * tau_per_layer`` (axisymmetric deposition)."""
    nphi, nz = grid.nphi, grid.nz
    act = np.full((nphi, nz), np.inf, dtype=dtype)
    act[:, :iz_base] = -np.inf
    for layer in range(n_layers):
        iz0 = iz_base + layer * layer_cells
        iz1 = min(iz0 + layer_cells, nz)
        if iz0 >= nz:
            break
        act[:, iz0:iz1] = layer * tau_per_layer
    return act


def active_at(activation_time: jax.Array, t) -> jax.Array:
    """Active (nphi, nz) mask at time t (strict: a column is active once the
    nozzle has swept past its leading edge)."""
    return activation_time < t


def newborn_between(activation_time: jax.Array, t_prev, t_next) -> jax.Array:
    """Columns that activate in the half-open step interval [t_prev, t_next):
    deposited at the start of the step from t_prev to t_next (t=0 births are
    included at the first step)."""
    return (activation_time >= t_prev) & (activation_time < t_next)
