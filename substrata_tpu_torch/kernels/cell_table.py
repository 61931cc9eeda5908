"""The broadphase cell table (kernel KP).

Replaces K1, ``substrata_tpu/physics/broadphase.py:build_cell_table``
(:70-112): each body's cell ``floor(pos * fl(1/cell_size))`` (the
reference divides by a static config value, which XLA folds into that
multiply), the int32-wrapping hash into ``grid_dim**2`` buckets, a trash
bucket for dead and non-collidable bodies, and the ``[buckets + 1, cap]``
table of body slots (with the MOVING/STATIC/SMALL bits when asked),
each bucket's bodies in index order (``jnp.argsort`` is stable), and the
count of bodies that found their bucket full.

``cell_table`` runs ``cell_table_plain`` for CPU tensors and the two
launches of ``csrc/cell_table.cu`` for CUDA tensors.
"""

from __future__ import annotations

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.physics.state import MotionType

launches = 0

P1, P2, P3 = 73856093, 19349663, 83492791
MASK32 = 0xFFFFFFFF
TBL_MOVING = 1 << 16
TBL_STATIC = 1 << 17
TBL_SMALL = 1 << 18


def wrap_i32(x):
    """int64 -> the int32 value with the same low 32 bits."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def hash_cells(cells, num_buckets: int):
    """int32-wrapping hash of int cells [..., 3] -> bucket [...] (int64)."""
    c = cells.to(torch.int64)
    h = (wrap_i32(c[..., 0] * P1) ^ wrap_i32(c[..., 1] * P2) ^ wrap_i32(c[..., 2] * P3))
    return (h & MASK32) % num_buckets


def _run_rank(sorted_keys):
    """Rank of each element within its run of equal sorted keys."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, device=sorted_keys.device)
    start = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(start, idx, 0), dim=0).values
    return idx - run_start


def cell_table_plain(pos, alive, collidable, awake, motion_type, bound_radius, *,
                     num_buckets: int, cap: int, rcp_cell: float, cell_size: float,
                     with_flags: bool):
    n = pos.shape[0]
    dev = pos.device
    cells = torch.floor(pos * rcp_cell).to(torch.int32)
    h = hash_cells(cells, num_buckets)
    h = torch.where(alive & collidable, h, num_buckets)
    h_sorted, order = torch.sort(h, stable=True)
    rank = _run_rank(h_sorted)
    entry = order
    if with_flags:
        is_static = motion_type == int(MotionType.STATIC)
        moving = awake & ~is_static
        small = 2.0 * bound_radius <= cell_size
        bits = (moving.long() * TBL_MOVING + is_static.long() * TBL_STATIC
                + small.long() * TBL_SMALL)
        entry = entry | bits[order]
    table = torch.full(((num_buckets + 1) * cap,), -1, dtype=torch.int64, device=dev)
    in_cap = rank < cap
    slot = torch.where(in_cap, h_sorted * cap + rank, (num_buckets + 1) * cap - 1)
    table.index_put_((slot,), torch.where(in_cap, entry, -1))
    table = table.reshape(num_buckets + 1, cap)
    table[num_buckets] = -1
    overflow = torch.sum((~in_cap) & (h_sorted < num_buckets)).to(torch.int32)
    return table.to(torch.int32), cells, overflow


def cell_table(pos, alive, collidable, awake, motion_type, bound_radius, *, num_buckets: int,
               cap: int, rcp_cell: float, cell_size: float, with_flags: bool):
    """KP: (table [num_buckets + 1, cap] i32, cells [N, 3] i32, overflow []
    i32).  The twin for CPU tensors, ``csrc/cell_table.cu`` for CUDA ones."""
    global launches
    kw = dict(num_buckets=num_buckets, cap=cap, rcp_cell=rcp_cell, cell_size=cell_size,
              with_flags=with_flags)
    if pos.device.type == "cpu":
        return cell_table_plain(pos, alive, collidable, awake, motion_type, bound_radius, **kw)
    dev = pos.device
    n = pos.shape[0]
    for t, name, dt, shp in ((pos, "pos", torch.float32, (n, 3)),
                             (alive, "alive", torch.bool, (n,)),
                             (collidable, "collidable", torch.bool, (n,)),
                             (awake, "awake", torch.bool, (n,)),
                             (motion_type, "motion_type", torch.int32, (n,)),
                             (bound_radius, "bound_radius", torch.float32, (n,))):
        build.check(t, name, dt, shp, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.empty((num_buckets + 1, cap), **i32)
    cells = torch.empty((n, 3), **i32)
    overflow = torch.empty((), **i32)
    scratch = torch.empty((2 * n + num_buckets,), **i32)
    build.launch("cell_table", pos, alive, collidable, awake, motion_type, bound_radius, n,
                 num_buckets, cap, float(rcp_cell), float(cell_size), int(bool(with_flags)),
                 cells, scratch, table, overflow)
    launches += 1
    return table, cells, overflow
