"""The broadphase cell table (kernel KP).

Replaces K1, ``substrata_tpu/physics/broadphase.py:build_cell_table``
(:70-112): each body's cell ``floor(pos * fl(1/cell_size))`` (the
reference divides by a static config value, which XLA folds into that
multiply), the int32-wrapping hash into ``grid_dim**2`` buckets, a trash
bucket for dead and non-collidable bodies, and the ``[buckets + 1, cap]``
table of body slots (with the MOVING/STATIC/SMALL bits when asked),
each bucket's bodies in index order (``jnp.argsort`` is stable), and the
count of bodies that found their bucket full.

``cell_table`` runs ``cell_table_plain`` for CPU tensors and the three
launches of ``csrc/cell_table.cu`` for CUDA tensors (a body's rank in its
bucket from the bucket's list of bodies, no walk in index order).
"""

from __future__ import annotations

import functools

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.physics.state import MotionType

launches = 0

P1, P2, P3 = 73856093, 19349663, 83492791
MASK32 = 0xFFFFFFFF
TBL_MOVING = 1 << 16
TBL_STATIC = 1 << 17
TBL_SMALL = 1 << 18
KLIST = 32             # csrc/cell_table.cu:kList


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


@functools.lru_cache(maxsize=64)
def _layout(n: int, nb: int, cap: int):
    """Offsets (int32 words) of one call's buffer: the scratch first (16-byte
    aligned for the crowded pass's vector loads), then the table, cells and
    overflow; the total."""
    scratch = 2 * n + nb + 1 + (n // (KLIST + 1) + 1) + nb * KLIST
    table = (scratch + 3) // 4 * 4
    cells = table + (nb + 1) * cap
    overflow = cells + 3 * n
    return table, cells, overflow, overflow + 1


def cell_table(pos, alive, collidable, awake, motion_type, bound_radius, *, num_buckets: int,
               cap: int, rcp_cell: float, cell_size: float, with_flags: bool):
    """KP: (table [num_buckets + 1, cap] i32, cells [N, 3] i32, overflow []
    i32).  The twin for CPU tensors, ``csrc/cell_table.cu`` for CUDA ones;
    the three outputs are views of one buffer, which also holds the
    kernels' scratch."""
    global launches
    if pos.device.type == "cpu":
        return cell_table_plain(pos, alive, collidable, awake, motion_type, bound_radius,
                                num_buckets=num_buckets, cap=cap, rcp_cell=rcp_cell,
                                cell_size=cell_size, with_flags=with_flags)
    dev = pos.device
    n = pos.shape[0]
    check = build.check
    check(pos, "pos", torch.float32, (n, 3), dev)
    check(alive, "alive", torch.bool, (n,), dev)
    check(collidable, "collidable", torch.bool, (n,), dev)
    check(awake, "awake", torch.bool, (n,), dev)
    check(motion_type, "motion_type", torch.int32, (n,), dev)
    check(bound_radius, "bound_radius", torch.float32, (n,), dev)
    o_table, o_cells, o_over, total = _layout(n, num_buckets, cap)
    buf = torch.empty((total,), dtype=torch.int32, device=dev)
    ptr = buf.data_ptr()
    rc = build.kernel("cell_table")(
        pos.data_ptr(), alive.data_ptr(), collidable.data_ptr(), awake.data_ptr(),
        motion_type.data_ptr(), bound_radius.data_ptr(), n, num_buckets, cap, rcp_cell,
        cell_size, 1 if with_flags else 0, ptr + 4 * o_cells, ptr, ptr + 4 * o_table,
        ptr + 4 * o_over, build.stream())
    build.raise_if(rc, "cell_table")
    launches += 1
    return (buf.as_strided((num_buckets + 1, cap), (cap, 1), o_table),
            buf.as_strided((n, 3), (3, 1), o_cells), buf.as_strided((), (), o_over))
