"""Hard inputs for the two stable counting sorts: KP's cell table and KT's
grouping.

These are the inputs where a bucket or a code's slice fills, so the order
of ties decides who is dropped, and where nothing is live.  The CPU tests
hold the twins against the reference on them at a small size;
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the kernels against
the twins on them at full size.  Everything is numpy, made from a seed;
slot order is shuffled so that index order is not space order.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import layout
from substrata_tpu_torch.kernels.cell_table import hash_cells

CELL_CASES = ("one_cell", "cap_plus_one", "none_alive", "ragged_pile")
GROUP_CASES = ("over_cap_clamped", "all_invalid")


def _body_fields(rng, pos, alive, cell_size):
    n = pos.shape[0]
    return dict(pos=np.ascontiguousarray(pos, dtype=np.float32), alive=alive,
                collidable=rng.random(n) < 0.97, awake=rng.random(n) < 0.6,
                motion_type=rng.integers(0, 3, n).astype(np.int32),
                bound_radius=rng.uniform(0.1, cell_size, n).astype(np.float32))


def cell_bodies(case: str, n: int, grid_dim: int, cap: int, cell_size: float = 1.4,
                seed: int = 0):
    """The fields KP reads (pos, alive, collidable, awake, motion_type,
    bound_radius) of ``n`` bodies for ``grid_dim ** 2`` buckets:

    - ``one_cell``: every body in the cell at the origin, 90% alive;
    - ``cap_plus_one``: cells with distinct buckets, ``cap + 1`` bodies
      each, all alive and collidable (the slots past the last full cell
      dead);
    - ``none_alive``: bodies spread out, none alive;
    - ``ragged_pile``: half the bodies heaped in 8 cells (buckets past a
      kernel's list), the rest spread, 90% alive;
    - ``lattice``: the capacity tier's layout, 3 layers of a 1.7 m lattice
      with 0.15 m of jitter, all alive.
    """
    rng = np.random.default_rng(seed)
    nb = grid_dim * grid_dim
    span = grid_dim * cell_size
    spread = np.stack([rng.uniform(-span / 2, span / 2, n), rng.uniform(-span / 2, span / 2, n),
                       rng.uniform(0.0, 3 * cell_size, n)], axis=1)
    inner = rng.uniform(0.02, 0.98, (n, 3)) * cell_size
    if case == "one_cell":
        return _body_fields(rng, inner, rng.random(n) < 0.9, cell_size)
    if case == "none_alive":
        return _body_fields(rng, spread, np.zeros(n, bool), cell_size)
    if case == "ragged_pile":
        heap = rng.integers(0, 8, n)
        corner = np.stack([heap % 4, heap // 4, np.zeros(n, np.int64)], axis=1) * cell_size
        pos = np.where((rng.random(n) < 0.5)[:, None], inner + corner, spread)
        return _body_fields(rng, pos, rng.random(n) < 0.9, cell_size)
    if case == "lattice":
        side = int(np.ceil((n / 3) ** 0.5))
        k = np.arange(n)
        pos = np.stack([(k % side - side / 2) * 1.7, (k // side % side - side / 2) * 1.7,
                        0.6 + (k // (side * side)) * 1.2], axis=1)
        pos[:, :2] += rng.uniform(-0.15, 0.15, (n, 2))
        return _body_fields(rng, pos[rng.permutation(n)], np.ones(n, bool), cell_size)
    if case != "cap_plus_one":
        raise ValueError(f"unknown cell case {case!r}")
    want = min(n // (cap + 1), nb)
    cand = np.stack([rng.integers(-grid_dim, grid_dim, 8 * want + 64),
                     rng.integers(-grid_dim, grid_dim, 8 * want + 64),
                     rng.integers(0, 4, 8 * want + 64)], axis=1)
    buckets = hash_cells(torch.as_tensor(cand), nb).numpy()
    _, first = np.unique(buckets, return_index=True)
    cells = cand[np.sort(first)[:want]]
    pos = spread.copy()
    alive = np.zeros(n, bool)
    m = len(cells) * (cap + 1)
    pos[:m] = np.repeat(cells, cap + 1, axis=0) * cell_size + inner[:m]
    alive[:m] = True
    perm = rng.permutation(n)
    out = _body_fields(rng, pos[perm], alive[perm], cell_size)
    out["collidable"] = np.ones(n, bool)
    return out


def _pairs_of_code(rng, shape_type, code, count):
    """``count`` distinct ordered pairs (a, b), a != b, of shape types
    (code // 4, code % 4)."""
    a_pool = np.flatnonzero(shape_type == code // 4)
    b_pool = np.flatnonzero(shape_type == code % 4)
    if len(a_pool) * len(b_pool) - (len(a_pool) if code // 4 == code % 4 else 0) < count:
        raise ValueError(f"too few bodies for {count} pairs of code {code}")
    out = set()
    while len(out) < count:
        a = rng.choice(a_pool, count)
        b = rng.choice(b_pool, count)
        for x, y in zip(a.tolist(), b.tolist()):
            if x != y and len(out) < count:
                out.add((x, y))
    return np.array(sorted(out), np.int64).reshape(-1, 2)


def group_pairs(case: str, shape_type, p: int, max_pairs: int, seed: int = 0):
    """A pair list (pair_a, pair_b int32, pair_valid bool) of length ``p``
    over bodies whose types (``shape_type``, spheres, boxes and capsules
    present; a body of type -1 is never picked) make codes 0-2, 4-6 and
    8-10:

    - ``over_cap_clamped``: code 1's run 1.5 times its bucket (overflow),
      code 6's run so late in the sorted order that its slice starts at
      ``p - cap`` and spans code 5's run (masked slots), a short code 10 run
      and a few invalid pairs after it; the rest spread over codes 0, 2, 4
      and 5; shuffled;
    - ``all_invalid``: random bodies (some -1), every pair invalid.
    """
    rng = np.random.default_rng(seed)
    st = np.asarray(shape_type)
    if case == "all_invalid":
        pa = rng.integers(-1, len(st), p).astype(np.int32)
        pb = rng.integers(-1, len(st), p).astype(np.int32)
        return pa, pb, np.zeros(p, bool)
    if case != "over_cap_clamped":
        raise ValueError(f"unknown group case {case!r}")
    cap = layout.bucket_cap(1, max_pairs, p)
    if p < 2 * cap:
        raise ValueError(f"p = {p} leaves no room below a mixed bucket of {cap}")
    runs = {1: cap + cap // 2, 6: cap // 4, 10: cap // 8}
    invalid = cap // 8
    rest = p - sum(runs.values()) - invalid
    for k, code in enumerate((0, 2, 4, 5)):
        runs[code] = rest // 4 + (1 if k < rest % 4 else 0)
    pairs = np.concatenate([_pairs_of_code(rng, st, code, count)
                            for code, count in sorted(runs.items())]
                           + [np.full((invalid, 2), -1)])
    valid = np.arange(p) < p - invalid
    perm = rng.permutation(p)
    return (pairs[perm, 0].astype(np.int32), pairs[perm, 1].astype(np.int32), valid[perm])
