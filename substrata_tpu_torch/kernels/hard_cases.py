"""Hard inputs for the two stable counting sorts (KP's cell table and KT's
grouping), for KH's ray trace, for KL's character update, for KB's
static contacts, for the contact solve (KQ's setup and KC), for the
rotation every rotating kernel shares, for the pair finder (KS), the
downmix (KG), the event digest (KN), the spatialiser (KF), the vehicle
forces (KJ), KT's incidence table, the closed forms (KK), the mix's
per-source setup (KAA), the hull contacts (KO), the pose (KZ), the halo
exchange (KAD), the sleep pass (KV), KT's compaction and KF's folded
epilogue.

For the sorts, these are the inputs where a bucket or a code's slice
fills, so the order of ties decides who is dropped, and where nothing is
live.  For the rays: more than k candidates tied at a zero entry key, a
body met twice through a bucket-hash collision, rays whose every candidate
row is empty, single-step marches, a trimesh whose cells hold fewer than 8
triangles.  For the character: scenes whose chosen update lands the stair
walk at the first, a late and the last of its 9 depths and at none, takes
the forward test column, and sticks to the floor at each of its 3
offsets, with 3 gather centres (1.4 m cells) and 2 (4 m), and a trimesh
step.  For the static contacts: the tie rules (equal depths across
candidate slots, against the heightfield, across samples; hull support
ties), a cell list cut by the candidate count, empty cells, cell
boundaries to the ulp, samples outside the grid and behind a far plane,
ineligible bodies and the present shape types.  For the digest: masks
with nothing set, exactly full, one over, all set, set only at word and
tile edges, ragged lengths and 65,536 pair slots.  For the spatialiser:
1 to 1,024 frames, one tap, alpha 1 and near 0, no send, no HRTF, the
low-pass and the pan path mixed among the sources.  For the vehicles:
each type active and inactive, airborne wheels, 2 and 4 wheels, the
shift, reverse, brake and coasting edges, the unflip window, the
propeller at the waterline to the ulp, near-still chassis, the righting
controller, 1 and 33 vehicles.  For the incidence table: nothing
occupied, static b's, a body's list exactly full and one over, one body in
every entry, self-pairs, cpb 1, 8 and 16, ragged N, a pair-blocked stride
and the largest packed key.  For the closed forms: every code, empty
buckets, a bucket's first and last slot, a warp of one pair, of 4, 5 and
32 distinct pairs, capsules parallel to a box face, sensors, both
layouts at every width, a single-combo world's stale ids and ragged
bucket sizes.  For the audio setup: 1 to 1,024 sources, 1 and 3 layers,
sources at the listener, behind it and straight above it, the azimuth
wrap, inactive sources, the Doppler clamps, occlusion and a mute rate of
0.  For the hull contacts: every hull code, a mesh step's sparse buckets,
empty and full buckets, ragged slot counts, cube faces at one depth, the
0.98 bias and the margin to float32 rounding, separated pairs, sensors,
a 32-vertex hull and the pair-blocked layout.  For the pose: 1, 63, 64,
65 and 256 joints, clips at their first and last frames, every override,
post rotation and grab, and padded avatars.  For the halo exchange: no
row masked, exactly H, H - 1 and H + 1, every row, H = rows_in, rows on a
threshold and one ulp either side, dead and NaN rows there, a ragged row
count, 1, 2 and 8 slabs and both phases of 2 x 2 tiles.  For the sleep
pass: 1, 8, 16 and 40 slots a body, 1, 2 and 4 rows an entry, full
tables, entries with no valid row, static counterparts, NaN speeds and
impulses, a fast, a NaN and both fast wakes, kinematic bodies, all
asleep, and 1, 33 and 65,536 bodies.  For KT's compaction: nothing
valid, one class only, 1 to 1,025 rows about a group's and a block's
edges, room for exactly the touching rows, one less, between them and the
valid ones and past every row, valid rows with a = -1, penetrations of
0.0, -0.0, NaN and the denormals, and the 65,536-body tier.  For KF's
folded epilogue: heads at exactly a buffer's end and one ulp before it,
looping, streaming, inactive and finished sources, removal on finish, NaN
levels, 1 to 1,024 sources and 1 or 3 layers.  The CPU tests hold the
twins against the reference on them at a small size;
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the kernels against
the twins on them.  Everything is numpy, made from a seed; slot order is
shuffled so that index order is not space order.
"""

from __future__ import annotations

import dataclasses

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


# ---------------------------------------------------------------------------
# KT: compaction scenes.
# ---------------------------------------------------------------------------

COMPACT_CASES = ("none_valid", "all_touching", "all_speculative", "c1", "c1023", "c1025",
                 "c257", "m_is_touching", "m_touching_less_1", "m_between", "m_past_c",
                 "a_minus_1", "pen_edges", "capacity")
COMPACT_C = 3000
# The 65,536-body tier: 49,152 box-box pairs of 4 rows, and the most
# compacted rows its 32-bit incidence key allows (SimConfig's auto value).
COMPACT_CAPACITY = (4 * 49_152, 16_383)
COMPACT_FIELDS = ("a", "b", "point", "normal", "penetration", "valid", "friction",
                  "restitution", "key")


@dataclasses.dataclass
class CompactScene:
    """KT's compaction inputs (numpy): the contact rows by
    ``COMPACT_FIELDS`` (narrowphase.CONTACT_FIELDS' order) and
    ``max_active``."""
    rows: dict
    max_active: int

    @property
    def counts(self):
        """(touching, valid) rows, as the reference counts them."""
        v = self.rows["valid"]
        t = v & (self.rows["penetration"] >= np.finfo(np.float32).tiny)
        return int(t.sum()), int(v.sum())


def compact_scene(case: str, seed: int = 0) -> CompactScene:
    """3,000 rows unless named, about 70% valid, about half of those
    touching (penetration up to 0.05 m; the speculative ones at -0.04 m to
    0), bodies 0-999 (b = -1 for static rows), keys spread over int32;
    ``max_active`` half the rows unless named:

    - ``none_valid``: every row invalid (all fills, no overflow);
    - ``all_touching``, ``all_speculative``: every row valid of one class
      (2,000 rows of room: the first overflows, the second drops 1,000);
    - ``c{C}``: 1 row (room for 4), 1,023 and 1,025 rows (either side of
      the parent kernel's 1,024-row tile), 257 rows (one past a block's 256
      rows at one group a warp);
    - ``m_is_touching``, ``m_touching_less_1``: room for exactly the
      touching rows, and one less (overflow 1);
    - ``m_between``: room between the touching and the valid rows;
    - ``m_past_c``: room for more rows than there are;
    - ``a_minus_1``: a tenth of the valid rows of each class with a = -1
      (placed, written as empty slots with their floats copied);
    - ``pen_edges``: every row valid, penetrations 0.0, -0.0, NaN, the
      smallest positive and negative denormals, the largest denormal, the
      smallest normal and 1e-3 in turn (only the last two touch: the
      reference reads a denormal as 0);
    - ``capacity``: the 65,536-body tier's 196,608 rows into 16,383.
    """
    if case not in COMPACT_CASES:
        raise ValueError(f"unknown compact case {case!r}")
    rng = np.random.default_rng(seed)
    c = {"c1": 1, "c1023": 1023, "c1025": 1025, "c257": 257,
         "capacity": COMPACT_CAPACITY[0]}.get(case, COMPACT_C)
    valid = rng.random(c) < 0.7
    pen = np.where(rng.random(c) < 0.5, rng.uniform(1e-4, 0.05, c),
                   rng.uniform(-0.04, 0.0, c)).astype(np.float32)
    if case == "none_valid":
        valid[:] = False
    elif case in ("all_touching", "all_speculative"):
        valid[:] = True
        pen = np.abs(pen) + np.float32(1e-4)
        if case == "all_speculative":
            pen = -pen
    elif case == "pen_edges":
        valid[:] = True
        tiny = np.finfo(np.float32).tiny
        edges = np.array([0.0, -0.0, np.nan, 1e-45, -1e-45, np.nextafter(tiny, 0), tiny, 1e-3],
                         np.float32)
        pen = np.resize(edges, c)
    a = rng.integers(0, 1000, c).astype(np.int32)
    b = np.where(rng.random(c) < 0.2, -1, rng.integers(0, 1000, c)).astype(np.int32)
    if case == "a_minus_1":
        a[valid & (rng.random(c) < 0.1)] = -1
    rows = dict(a=a, b=b, point=rng.uniform(-50, 50, (c, 3)).astype(np.float32),
                normal=rng.normal(0, 1, (c, 3)).astype(np.float32), penetration=pen,
                valid=valid, friction=rng.uniform(0, 1, c).astype(np.float32),
                restitution=rng.uniform(0, 1, c).astype(np.float32),
                key=rng.integers(-2 ** 31, 2 ** 31 - 1, c).astype(np.int32))
    scene = CompactScene(rows=rows, max_active=max(c // 2, 1))
    n_touch, n_valid = scene.counts
    scene.max_active = {"c1": 4, "none_valid": 1000, "all_touching": 2000,
                        "all_speculative": 2000, "m_is_touching": n_touch,
                        "m_touching_less_1": n_touch - 1,
                        "m_between": (n_touch + n_valid) // 2, "m_past_c": c + 100,
                        "a_minus_1": n_valid + 10, "pen_edges": c,
                        "capacity": COMPACT_CAPACITY[1]}.get(case, scene.max_active)
    return scene


def compact_inputs(scene: CompactScene, device):
    """``layout.compact``'s arguments (the rows tuple, max_active) on
    ``device``."""
    return (tuple(torch.as_tensor(scene.rows[k], device=device) for k in COMPACT_FIELDS),
            scene.max_active)


# ---------------------------------------------------------------------------
# KH: ray scenes.
# ---------------------------------------------------------------------------

RAY_CASES = ("tied_keys", "hash_collision", "empty_rows", "sparse_trimesh")
# (n_steps, body_steps, dedup): the particles', the wheels', the facade's
# and a single-step march.
RAY_CALLS = {"particles": (4, 1, False), "wheels": (4, 4, True), "facade": (16, 16, True),
             "single_step": (1, 1, True), "single_step_no_dedup": (1, 1, False)}


def _box_bound(he):
    return float(np.linalg.norm(np.asarray(he, np.float64)))


def _bodies(capacity, rows):
    """BodyState fields (numpy, the port's BODY_FIELDS) of ``rows`` [(shape
    type, params, pos, quat, bound radius)], static and collidable; the
    slots past them dead."""
    from substrata_tpu_torch.physics import state
    a = {k: v.numpy().copy() for k, v in vars(state.zero_body_state(capacity, device="cpu")).items()}
    for i, (st, prm, pos, quat, bound) in enumerate(rows):
        a["pos"][i] = pos
        a["quat"][i] = quat
        a["shape_type"][i] = st
        a["shape_params"][i] = list(prm) + [0.0] * (4 - len(prm))
        a["bound_radius"][i] = bound
        a["alive"][i] = True
        a["motion_type"][i] = 0
        a["layer"][i] = 0
        a["friction"][i] = 0.5
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@dataclasses.dataclass
class RayScene:
    """Bodies (numpy BodyState fields), a SimConfig's sizes, the rays, the
    ground plane's height (None: no heightfield) and the static trimesh
    (verts, tris, materials, owners) or None."""
    bodies: dict
    config: dict
    origins: np.ndarray
    dirs: np.ndarray
    max_ts: np.ndarray
    ground_z: float | None = 0.0
    trimesh: tuple | None = None


def ray_scene(case: str, seed: int = 0) -> RayScene:
    """The inputs of one hard ray case:

    - ``tied_keys``: two clusters of 8 spheres (0.95 m, in one 2 m cell)
      and 16 oversize spheres (1.9 m) whose bounding spheres all hold the
      cluster's centre; rays start there (every key 0: 24 ties, more than
      k = 16), and rays cross the clusters from outside;
    - ``hash_collision``: 48 boxes over 16 buckets (grid 4), so neighbour
      cells share buckets and a ray's candidate row meets a body twice;
    - ``empty_rows``: 3 bodies on a 64 x 64 grid and rays whose every bucket
      row (and the oversize row) is empty, up and down (survivor 0 is the
      clamped -1: body 0's normal is reported on a miss);
    - ``sparse_trimesh``: a 4-triangle ramp and 3 small triangles (cells
      of 0-3 triangles) with owners and materials, boxes on and beside it.
    """
    rng = np.random.default_rng(seed)
    q0 = [0.0, 0.0, 0.0, 1.0]
    if case == "tied_keys":
        rows, centres = [], np.array([[3.0, 3.0, 1.0], [-5.0, 1.0, 1.0]], np.float32)
        for c in centres:
            for _ in range(8):
                r = 0.95
                rows.append((0, [r], c + rng.uniform([-0.5, -0.5, -0.3], [0.5, 0.5, 0.3]), q0,
                             r))
            for _ in range(16):
                r = 1.9
                rows.append((0, [r], c + rng.uniform(-1.0, 1.0, 3), q0, r))
        n_in = 96
        o = np.repeat(centres, n_in // 2, axis=0) + rng.uniform(-0.05, 0.05, (n_in, 3))
        d = _unit(rng, n_in)
        mt = rng.uniform(0.5, 6.0, n_in)
        n_out = 64
        start = np.repeat(centres, n_out // 2, axis=0) + _unit(rng, n_out) * 6.0
        target = np.repeat(centres, n_out // 2, axis=0) + rng.uniform(-0.5, 0.5, (n_out, 3))
        d2 = target - start
        d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
        return RayScene(_bodies(96, rows), dict(capacity=96, max_pairs=512, grid_dim=32,
                                                cell_size=2.0, cell_capacity=8),
                        np.concatenate([o, start]).astype(np.float32),
                        np.concatenate([d, d2]).astype(np.float32),
                        np.concatenate([mt, rng.uniform(6.0, 12.0, n_out)]).astype(np.float32))
    if case == "hash_collision":
        rows = []
        for _ in range(48):
            he = rng.uniform(0.15, 0.4, 3)
            q = rng.normal(size=4)
            rows.append((1, list(he), rng.uniform([-6, -6, 0.3], [6, 6, 2.0]), q / np.linalg.norm(q),
                         _box_bound(he)))
        n = 256
        o = rng.uniform([-7, -7, 0.2], [7, 7, 2.5], (n, 3))
        return RayScene(_bodies(64, rows), dict(capacity=64, max_pairs=256, grid_dim=4,
                                                cell_size=1.4, cell_capacity=6),
                        o.astype(np.float32), _unit(rng, n),
                        rng.uniform(0.5, 8.0, n).astype(np.float32))
    if case == "empty_rows":
        rows = [(1, [0.4, 0.3, 0.2], [0.0, 0.0, 0.5], q0, _box_bound([0.4, 0.3, 0.2])),
                (0, [0.3], [2.0, 1.0, 0.5], q0, 0.3),
                (2, [0.2, 0.3], [-2.0, 1.0, 0.6], q0, 0.5)]
        grid, cell = 64, 1.4
        body_b = set(hash_cells(torch.as_tensor(np.floor(np.array([r[2] for r in rows])
                                                          / cell).astype(np.int64)),
                                grid * grid).tolist())
        keep_o, keep_d, keep_t = [], [], []
        while len(keep_o) < 96:
            o = rng.uniform([20, -40, 0.3], [40, 40, 6.0])
            d = _unit(rng, 1)[0]
            mt = rng.uniform(0.5, 8.0)
            pts = o[None] + d[None] * (np.arange(16) / 15.0 * mt)[:, None]
            cells = np.floor(pts / cell).astype(np.int64)
            nb = np.concatenate([cells + [dx, dy, 0] for dx in (-1, 0, 1) for dy in (-1, 0, 1)])
            nb = np.concatenate([nb, np.floor((o + d * 0.5 * mt) / cell).astype(np.int64)[None]
                                 + np.array([[dx, dy, 0] for dx in (-1, 0, 1)
                                             for dy in (-1, 0, 1)])])
            if body_b.isdisjoint(hash_cells(torch.as_tensor(nb), grid * grid).tolist()):
                keep_o.append(o)
                keep_d.append(d)
                keep_t.append(mt)
        return RayScene(_bodies(64, rows), dict(capacity=64, max_pairs=256, grid_dim=grid,
                                                cell_size=cell, cell_capacity=6),
                        np.array(keep_o, np.float32), np.array(keep_d, np.float32),
                        np.array(keep_t, np.float32))
    if case != "sparse_trimesh":
        raise ValueError(f"unknown ray case {case!r}")
    verts = np.array([[0, -4, 0.2], [8, -4, 1.2], [8, 4, 1.2], [0, 4, 0.2],
                      [-3, -3, 0.4], [-2, -3, 0.4], [-3, -2, 0.4],
                      [-6, 2, 0.1], [-5, 2, 0.6], [-6, 3, 0.1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [7, 8, 9], [7, 9, 8]], np.int32)
    mats = np.array([3, 4, 5, 6, 7], np.int32)
    owners = np.array([40, 40, 41, 42, 42], np.int32)
    rows = []
    for x in (1.0, 3.0, 5.0, -2.5):
        he = [0.3, 0.3, 0.3]
        rows.append((1, he, [x, 0.5, 1.2], q0, _box_bound(he)))
    n = 256
    o = rng.uniform([-7, -5, 2.0], [9, 5, 5.0], (n, 3))
    d = _unit(rng, n)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return RayScene(_bodies(48, rows), dict(capacity=48, max_pairs=256, grid_dim=16,
                                            cell_size=2.0, cell_capacity=6),
                    o.astype(np.float32), d.astype(np.float32),
                    rng.uniform(1.0, 10.0, n).astype(np.float32), ground_z=-1.0,
                    trimesh=(verts, tris, mats, owners))


def ray_inputs(scene: RayScene, call: str, device):
    """The port's ``ray_trace`` arguments for ``scene`` and one of
    RAY_CALLS on ``device``: (positional args, keyword args)."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.physics import broadphase, queries, state
    body = convert.body_state_from_numpy(scene.bodies, device=device)
    cfg = state.SimConfig(**scene.config)
    sw = state.default_static_world(0.0 if scene.ground_z is None else scene.ground_z,
                                    device=device)
    if scene.ground_z is None:
        sw = sw.replace(has_heightfield=torch.tensor(False, device=device))
    if scene.trimesh is not None:
        verts, tris, mats, owners = scene.trimesh
        sw = sw.replace(trimesh=state.build_trimesh(verts, tris, mats, tri_owner=owners,
                                                    device=device))
    n_steps, body_steps, dedup = RAY_CALLS[call]
    r = scene.origins.shape[0]
    args = (torch.as_tensor(scene.origins, device=device),
            torch.as_tensor(scene.dirs, device=device),
            torch.as_tensor(scene.max_ts, device=device), body,
            broadphase.build_cell_table(body, cfg)[0], queries.oversize_slots(body, cfg),
            sw.heightfield, sw.has_heightfield,
            torch.full((r,), -1, dtype=torch.int32, device=device), sw.hulls, sw.trimesh)
    return args, dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim, n_steps=n_steps,
                      body_steps=body_steps, collidable_only=True, k=16, dedup=dedup)


# ---------------------------------------------------------------------------
# KL: character scenes.
# ---------------------------------------------------------------------------

# The ridge profile of ``land_last``'s heightfield: (x index, height).
_RIDGES = ((1, 0.09873830527067184), (9, 0.10410208255052567), (10, 0.17199507355690002),
           (12, 0.0863935574889183), (13, 0.050855617970228195), (15, 0.18383747339248657),
           (24, 0.10678695142269135), (26, 0.033743951469659805))


@dataclasses.dataclass
class CharacterScene:
    """A world (static boxes [(half extents, position)], the ground plane's
    height or a heightfield (heights, origin, cell width), a static trimesh
    (verts, tris) or None), the cell size, the player's eye, its move, the
    number of chained updates, and what the twin's update ``at`` must do:
    ``branch`` is ("land", depth index or None), ("forward", True) or
    ("stick", offset index)."""
    boxes: list
    cell_size: float
    eye: tuple
    move: tuple
    updates: int
    at: int
    branch: tuple | None
    ground_z: float | None = 0.0
    heightfield: tuple | None = None
    trimesh: tuple | None = None


def character_scene(case: str) -> CharacterScene:
    """The inputs of one hard character case (found by search on the twin
    over obstacles, ledges and ridged heightfields; ``observe_branches``
    checks each):

    - ``land_first``: a floating slab (0.19-1.85 m) ahead: the landing's
      first depth holds the slab's side contact;
    - ``land_last``: a 33 x 33 heightfield of thin ridges across the walk
      (0.1 m cells): a ridge blocks, the ground beyond lands at the ninth
      depth;
    - ``land_late``: a 0.28 m step, run into at 6 m/s: the eighth depth;
    - ``land_none``: a slab (0.31-0.64 m) run into at 15 m/s: no depth;
    - ``forward_column``: a 0.2 m step: the landing is not flat and the
      forward column finds floor;
    - ``stick_0``, ``stick_1``, ``stick_2``: off a 0.22 m, 0.22 m and
      0.45 m ledge at 6 m/s: stuck at the 0.1, 0.25 and 0.5 m offset;
    - ``cell_4m``: the forward-column step in 4 m cells (2 gather centres);
    - ``trimesh_step``: a 0.3 m step of triangles, walked onto.
    """
    x3 = (3.0, 0.0, 0.0)
    if case == "land_first":
        return CharacterScene([([0.5, 1.0, 0.8320100290], [0.9345757582, 0.0, 1.0191089002])],
                              1.4, (0.0, 0.0, 1.67), x3, 4, 3, ("land", 0))
    if case == "land_last":
        h = np.zeros((33, 33), np.float32)
        for i, v in _RIDGES:
            if i < 33:
                h[i, :] = v
        return CharacterScene([], 1.4, (0.0, 0.0, 1.67), x3, 19, 18, ("land", 8), ground_z=None,
                              heightfield=(h, (-1.0, -1.6), 0.1))
    if case == "land_late":
        return CharacterScene([([0.5, 1.0, 0.1387921104], [0.8516887648, 0.0, 0.1387921104])],
                              1.4, (0.0, 0.0, 1.67), (6.0, 0.0, 0.0), 3, 2, ("land", 7))
    if case == "land_none":
        return CharacterScene([([0.5, 1.0, 0.1655556224], [1.0856218452, 0.0, 0.4726485972])],
                              1.4, (0.0, 0.0, 1.67), (15.0, 0.0, 0.0), 2, 1, ("land", None))
    if case in ("forward_column", "cell_4m"):
        return CharacterScene([([1.0, 1.0, 0.1], [1.35, 0.0, 0.1])],
                              1.4 if case == "forward_column" else 4.0, (0.0, 0.0, 1.67), x3, 2, 1,
                              ("forward", True))
    if case in ("stick_0", "stick_1", "stick_2"):
        h = 0.45 if case == "stick_2" else 0.22
        at = 1 if case == "stick_0" else 2
        return CharacterScene([([1.0, 2.0, h / 2], [-0.7, 0.0, h / 2])], 1.4,
                              (0.25, 0.0, h + 1.67), (6.0, 0.0, 0.0), at + 1, at,
                              ("stick", int(case[-1])))
    if case != "trimesh_step":
        raise ValueError(f"unknown character case {case!r}")
    verts = np.array([[1.0, -3, 0.3], [5, -3, 0.3], [5, 3, 0.3], [1.0, 3, 0.3],
                      [1.0, -3, 0.0], [1.0, 3, 0.0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3], [4, 0, 3], [4, 3, 5]], np.int32)
    return CharacterScene([], 1.4, (0.6, 0.0, 1.67), x3, 4, 3, None, trimesh=(verts, tris))


def character_world(scene: CharacterScene, device):
    """The port's PhysicsWorld of ``scene`` on ``device``."""
    from substrata_tpu_torch import MotionType, PhysicsObject, PhysicsWorld
    from substrata_tpu_torch.physics import shapes
    from substrata_tpu_torch.physics.state import SimConfig
    w = PhysicsWorld(SimConfig(capacity=64, max_pairs=256, grid_dim=16,
                               cell_size=scene.cell_size, cell_capacity=6), device=device)
    if scene.ground_z is not None:
        w.set_ground_plane(scene.ground_z)
    if scene.heightfield is not None:
        w.set_heightfield(*scene.heightfield)
    if scene.trimesh is not None:
        w.set_static_trimesh(*scene.trimesh)
    for he, pos in scene.boxes:
        w.add_object(PhysicsObject(shape=shapes.make_box(he), pos=np.array(pos, np.float32),
                                   motion_type=int(MotionType.STATIC)))
    w._flush()
    return w


CHARACTER_CASES = ("land_first", "land_last", "land_late", "land_none", "forward_column",
                   "stick_0", "stick_1", "stick_2", "cell_4m", "trimesh_step")


def observe_branches(update):
    """Run ``update()`` (one twin update) and report its batched probes as
    the twin reads them: the stair walk's landing (the first of the 9 depths
    with 0 < depth < 0.08, None for none), whether the forward column found
    floor, and stick-to-floor's first supported, non-steep offset.  Returns
    (update's result, {"land": ..., "forward": ..., "stick": ...}); a key
    is absent where the update did not probe it."""
    from substrata_tpu_torch.kernels import character as kl
    seen = []
    probe = kl.capsule_probe

    def record(feet, *a, **k):
        out = probe(feet, *a, **k)
        seen.append((feet, out))
        return out
    kl.capsule_probe = record
    try:
        result = update()
    finally:
        kl.capsule_probe = probe
    info = {}

    def scan(feet, out):
        n, pen, pt, _, vel, ok = out
        deep = torch.where(ok, pen, -1e9).max(dim=1).values
        sup, _, _, steep = kl.support_info(feet, n, pen, pt, vel, ok)
        return deep, sup & ~steep
    nine = [x for x in seen if x[0].shape[0] == 9]
    if nine:
        deep, flat = scan(*nine[0])
        cont = (deep > 0.0) & (deep < 0.08)
        info["land"] = int(torch.argmax(cont.to(torch.int32))) if bool(cont.any()) else None
        if len(nine) > 1:
            deep, flat = scan(*nine[1])
            info["forward"] = bool(((deep > 0.0) & (deep < 0.08) & flat).any())
    three = [x for x in seen if x[0].shape[0] == 3]
    if three:
        _, flat = scan(*three[0])
        info["stick"] = int(torch.argmax(flat.to(torch.int32))) if bool(flat.any()) else None
    return result, info


# ---------------------------------------------------------------------------
# KB: static-contact scenes.
# ---------------------------------------------------------------------------

STATIC_CASES = ("equal_depths", "full_cell", "empty_cell", "cell_boundary", "outside_grid",
                "behind_plane", "ineligible", "mixed_present", "present_subset", "ring_ties")
STATIC_KS = (1, 4, 8)
_HULL_ROWS, _HULL_VERTS = 4, 32


@dataclasses.dataclass
class StaticScene:
    """Bodies (numpy BodyState fields, the port's BODY_FIELDS), the static
    world as ``convert.static_world_from_numpy`` takes it (the heightfield,
    the trimesh with its grid built here, the hull library), the present
    shape types and the trimesh candidates a sample reads."""
    bodies: dict
    world: dict
    present: tuple = (True, True, True, True)
    max_tri_candidates: int = 16


def _tri_grid(verts, tris, origin, cell_w, gx, gy, cap):
    """``trimesh_grid``'s fill rule over a chosen grid: each triangle in
    every cell its xy bounding box covers (cell indices truncated, then
    clamped), in triangle order, the first ``cap`` of a cell kept, so that
    a cell's empty slots (-1) form a suffix."""
    ox, oy, cw = np.float32(origin[0]), np.float32(origin[1]), np.float32(cell_w)
    cell_tris = np.full((gx, gy, cap), -1, np.int32)
    count = np.zeros((gx, gy), np.int64)
    for t, tri in enumerate(tris):
        p = verts[tri]
        lo = ((p[:, :2].min(axis=0) - (ox, oy)) / cw).astype(np.int32)
        hi = ((p[:, :2].max(axis=0) - (ox, oy)) / cw).astype(np.int32)
        for ci in range(max(lo[0], 0), min(hi[0], gx - 1) + 1):
            for cj in range(max(lo[1], 0), min(hi[1], gy - 1) + 1):
                if count[ci, cj] < cap:
                    cell_tris[ci, cj, count[ci, cj]] = t
                count[ci, cj] += 1
    return cell_tris


def _static_world(tri=None, grid=None, ground_z=0.0, heightfield=None, hulls=()):
    """The ``static_world_from_numpy`` arrays: a flat ground at ``ground_z``
    (None: no heightfield) or ``heightfield`` (heights, origin, cell width);
    the trimesh (verts, tris) over ``grid`` (origin, cell width, GX, GY,
    cap); a hull library of ``_HULL_ROWS`` rows, ``hulls``' vertex lists
    padded with their first vertex (KB reads no face plane)."""
    if heightfield is not None:
        h, origin, cw = heightfield
        w = dict(heights=np.asarray(h, np.float32), origin=np.asarray(origin, np.float32),
                 cell_w=np.float32(cw), is_flat=False, has_heightfield=np.bool_(True))
    else:
        z = 0.0 if ground_z is None else ground_z
        w = dict(heights=np.full((8, 8), z, np.float32),
                 origin=np.array([-500.0, -500.0], np.float32),
                 cell_w=np.float32(1000.0 / 7), is_flat=True,
                 has_heightfield=np.bool_(ground_z is not None))
    w["water_z"] = np.float32(-1e10)
    if tri is not None:
        verts, tris = (np.ascontiguousarray(x, dt) for x, dt in zip(tri, (np.float32, np.int32)))
        origin, cw, gx, gy, cap = grid
        w["trimesh"] = dict(verts=verts, tris=tris, tri_mats=np.zeros(len(tris), np.int32),
                            tri_owner=np.full(len(tris), -1, np.int32),
                            cell_tris=_tri_grid(verts, tris, origin, cw, gx, gy, cap),
                            origin=np.asarray(origin, np.float32), cell_w=np.float32(cw),
                            n_tris=np.int32(len(tris)))
    hv = np.zeros((_HULL_ROWS, _HULL_VERTS, 3), np.float32)
    nv = np.zeros(_HULL_ROWS, np.int32)
    for h, cloud in enumerate(hulls):
        cloud = np.asarray(cloud, np.float32)
        hv[h] = cloud[0]
        hv[h, :len(cloud)] = cloud
        nv[h] = len(cloud)
    w["hulls"] = dict(verts=hv, n_verts=nv,
                      planes=np.zeros((_HULL_ROWS, _HULL_VERTS, 4), np.float32),
                      n_faces=np.zeros(_HULL_ROWS, np.int32))
    return w


def _static_bodies(rows, capacity=32, seed=0):
    """BodyState fields of ``rows``, each a dict with st, prm, pos and
    optionally quat, motion (default dynamic), layer (moving), awake,
    sensor, alive; friction and restitution seeded; the slots past them
    dead."""
    from substrata_tpu_torch.physics import state
    rng = np.random.default_rng(seed)
    a = {k: v.numpy().copy() for k, v in vars(state.zero_body_state(capacity, device="cpu")).items()}
    for i, r in enumerate(rows):
        a["pos"][i] = r["pos"]
        a["quat"][i] = r.get("quat", (0.0, 0.0, 0.0, 1.0))
        a["shape_type"][i] = r["st"]
        a["shape_params"][i] = list(r["prm"]) + [0.0] * (4 - len(r["prm"]))
        a["motion_type"][i] = r.get("motion", 2)
        a["layer"][i] = r.get("layer", 1)
        a["awake"][i] = r.get("awake", True)
        a["is_sensor"][i] = r.get("sensor", False)
        a["alive"][i] = r.get("alive", True)
        a["friction"][i] = rng.uniform(0.2, 0.9)
        a["restitution"][i] = rng.uniform(0.0, 0.5)
        a["bound_radius"][i] = 1.0
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def _sphere(x, y, z, r, **kw):
    return dict(st=0, prm=[r], pos=(x, y, z), **kw)


def _box(x, y, z, he, **kw):
    return dict(st=1, prm=list(he), pos=(x, y, z), **kw)


def _flat_tri(x0, y0, x1, y1, z):
    """A horizontal right triangle over [x0, x1] x [y0, y1] at height z,
    wound so that its normal is +z."""
    return [[x0, y0, z], [x1, y0, z], [x0, y1, z]]


def _quat(axis, deg):
    h = np.radians(deg) / 2
    return tuple(np.append(np.asarray(axis, np.float64) * np.sin(h), np.cos(h)).astype(np.float32))


def _tris_of(*triangles):
    verts = np.asarray([v for t in triangles for v in t], np.float32)
    return verts, np.arange(len(verts), dtype=np.int32).reshape(-1, 3)


def static_scene(case: str, seed: int = 0) -> StaticScene:
    """The inputs of one hard static-contact case:

    - ``equal_depths``: two coplanar triangles sharing an edge with spheres
      on it, above and below (equal depths: the lower candidate slot); two
      mirrored triangles whose closest points are at exactly equal distance
      from a sphere (the tie decides the point); a ground-level triangle
      whose row ties the heightfield's (the heightfield row stays); a box
      resting exactly on the ground (four samples tied at depth 0);
    - ``full_cell``: 40 triangles in one cell of capacity 32, read 16 at a
      time: the deepest at slots 20 and 36 (neither read);
    - ``empty_cell``: a bumpy heightfield and a 4 x 4 grid whose cells hold
      0 or a few triangles (capacity 6, all 6 read);
    - ``cell_boundary``: 1.4 m cells from (-7, -7), a triangle per cell at
      0 or 0.2 m in a checkerboard; spheres at the float32 cell boundaries
      and one ulp either side, in x and in y (5 candidates read);
    - ``outside_grid``: spheres past every edge of the grid, near and far
      (the clamped cell), and beside a wall triangle on the grid's edge, in
      front of it and behind it;
    - ``behind_plane``: a ramp, with samples behind its plane beyond its
      edges (the reference's sign rule: deep) and in front of it;
    - ``ineligible``: asleep, sensor, static, kinematic, layer-2, layer-3
      and dead boxes over triangles beside eligible ones;
    - ``mixed_present``: boxes, capsules, spheres and hulls at seeded poses
      over a seeded terrain of triangles and a bumpy heightfield;
    - ``present_subset``: boxes and hulls only, with only those two shape
      types present;
    - ``ring_ties``: a cube, an octahedron, a hull whose list repeats a
      vertex and a 32-vertex prism, upright and turned by 180 and 90
      degrees, resting on a triangle floor: ring directions tie on two
      vertices (the first wins), and samples tie at depth 0.
    """
    rng = np.random.default_rng(seed)
    if case == "equal_depths":
        cx, cy = -6.0, -6.0
        verts, tris = _tris_of(
            [[2, 2, 0.5], [4, 2, 0.5], [2, 4, 0.5]], [[4, 2, 0.5], [4, 4, 0.5], [2, 4, 0.5]],
            [[cx + 1, cy - 1, 0.25], [cx + 1, cy + 1, 0.25], [cx + 3, cy, 0.25]],
            [[cx - 1, cy + 1, 0.25], [cx - 1, cy - 1, 0.25], [cx - 3, cy, 0.25]],
            _flat_tri(6, -6, 8, -4, 0.0))
        rows = [_sphere(3.0, 3.0, 0.625, 0.25), _sphere(3.0, 3.0, 0.375, 0.25),
                _sphere(3.5, 2.5, 0.6, 0.2), _sphere(cx, cy, 1.25, 0.25),
                _sphere(cx, cy, 0.75, 0.25), _sphere(6.5, -5.5, 0.125, 0.25),
                _box(7.0, -5.5, 0.0625, (0.25, 0.25, 0.0625)), _box(-7.0, 7.0, 0.5, (0.5, 0.5, 0.5)),
                dict(st=2, prm=[0.25, 0.5], pos=(3.0, 3.0, 0.625), quat=_quat((1, 0, 0), 90))]
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (verts, tris), ((-8.0, -8.0), 4.0, 4, 4, 32)))
    if case == "full_cell":
        tri = []
        for j in range(40):
            x, y = rng.uniform(0.5, 2.5, 2)
            z = 0.6 if j in (20, 36) else 0.05 + 0.005 * j
            tri.append(_flat_tri(x, y, x + 1.2, y + 1.2, z))
        verts, tris = _tris_of(*tri)
        rows = [_box(x, y, 0.3, (0.3, 0.25, 0.2), quat=_quat(rng.normal(size=3), 20))
                for x, y in rng.uniform(1.0, 3.0, (10, 2))]
        rows += [_sphere(x, y, 0.35, 0.2) for x, y in rng.uniform(1.0, 3.0, (6, 2))]
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (verts, tris), ((0.0, 0.0), 4.0, 2, 2, 32)), max_tri_candidates=16)
    if case == "empty_cell":
        tri = []
        for ci, cj, n in ((0, 0, 3), (1, 2, 1), (2, 1, 6), (3, 3, 2)):
            for _ in range(n):
                x, y = -4.0 + 2 * ci + rng.uniform(0.1, 1.0), -4.0 + 2 * cj + rng.uniform(0.1, 1.0)
                tri.append(_flat_tri(x, y, x + 0.8, y + 0.8, rng.uniform(0.0, 0.3)))
        verts, tris = _tris_of(*tri)
        h = rng.uniform(-0.1, 0.15, (9, 9)).astype(np.float32)
        rows = []
        for ci in range(4):
            for cj in range(4):
                x, y = -4.0 + 2 * ci + 0.9, -4.0 + 2 * cj + 0.9
                rows.append(_box(x, y, 0.25, (0.3, 0.3, 0.2), quat=_quat(rng.normal(size=3), 15)))
                rows.append(_sphere(x + 0.3, y - 0.4, 0.3, 0.25))
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (verts, tris), ((-4.0, -4.0), 2.0, 4, 4, 6), heightfield=(h, (-4.0, -4.0), 1.0)))
    if case == "cell_boundary":
        ox, cw = np.float32(-7.0), np.float32(1.4)
        tri = []
        for ci in range(10):
            for cj in range(10):
                x0, y0 = ox + ci * cw + np.float32(0.02), ox + cj * cw + np.float32(0.02)
                z = 0.2 if (ci + cj) % 2 else 0.0
                tri.append([[x0, y0, z], [x0 + 1.36, y0, z], [x0, y0 + 1.36, z]])
                tri.append([[x0 + 1.36, y0, z], [x0 + 1.36, y0 + 1.36, z], [x0, y0 + 1.36, z]])
        verts, tris = _tris_of(*tri)
        rows = []
        for k in (1, 3, 5, 8):
            edge = np.float32(np.float32(k * cw) + ox)
            for x in (np.nextafter(edge, np.float32(-np.inf)), edge,
                      np.nextafter(edge, np.float32(np.inf))):
                mid = np.float32(ox + (k - 0.5) * cw)
                rows.append(_sphere(float(x), float(mid), 0.45, 0.3))
                rows.append(_sphere(float(mid), float(x), 0.45, 0.3))
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (verts, tris), ((float(ox), float(ox)), float(cw), 10, 10, 8), ground_z=None),
            max_tri_candidates=5)
    if case == "outside_grid":
        verts, tris = _tris_of(
            [[0.0, 0.5, 0.0], [0.0, 1.5, 0.0], [0.0, 1.0, 1.0]],
            [[0.0, 2.5, 0.0], [0.0, 3.0, 1.0], [0.0, 3.5, 0.0]],
            _flat_tri(0.0, 4.0, 2.0, 6.0, 0.1), _flat_tri(6.0, 6.0, 8.0, 8.0, 0.1),
            _flat_tri(6.0, 0.0, 8.0, 2.0, 0.1))
        rows = [_sphere(-0.2, 1.0, 0.4, 0.3), _sphere(-0.2, 3.0, 0.4, 0.3),
                _sphere(-1e-3, 5.0, 0.3, 0.25), _sphere(-50.0, 5.0, 0.3, 0.25),
                _sphere(1.0, -0.05, 0.3, 0.25), _sphere(9.0, 7.0, 0.3, 0.25),
                _sphere(7.0, 100.0, 0.3, 0.25), _sphere(8.05, 1.0, 0.3, 0.25),
                _sphere(-3e3, -3e3, 0.3, 0.25),
                _box(-0.15, 1.0, 0.5, (0.1, 0.3, 0.3), quat=_quat((0, 0, 1), 10))]
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (verts, tris), ((0.0, 0.0), 2.0, 4, 4, 8), ground_z=-0.5))
    if case == "behind_plane":
        verts, tris = _tris_of([[0.0, 0.0, 0.0], [4.0, 0.0, 2.0], [0.0, 4.0, 0.0]],
                               [[4.0, 0.0, 2.0], [4.0, 4.0, 2.0], [0.0, 4.0, 0.0]])
        rows = [_sphere(x, y, z, 0.2) for x, y, z in (
            (5.0, 2.0, 1.0), (4.5, 1.0, 0.5), (6.0, 3.0, 0.2), (2.0, 2.0, 0.5), (2.0, 2.0, 1.3),
            (3.0, 3.0, 1.6), (1.0, 1.0, 0.9), (7.5, 2.0, -2.0))]
        rows += [_box(x, 2.0, z, (0.3, 0.3, 0.3), quat=_quat(rng.normal(size=3), 30))
                 for x, z in ((4.8, 1.5), (2.0, 1.0), (3.0, 1.2))]
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (verts, tris), ((0.0, 0.0), 8.0, 1, 1, 8), ground_z=0.0), max_tri_candidates=2)
    if case == "ineligible":
        verts, tris = _tris_of(*[_flat_tri(x, y, x + 2.0, y + 2.0, 0.1)
                                 for x in (0.0, 2.0, 4.0) for y in (0.0, 2.0)])
        flags = (dict(awake=False), dict(sensor=True), dict(motion=0), dict(motion=1),
                 dict(layer=2), dict(layer=3), dict(alive=False), dict(layer=0), {})
        rows = []
        for j, fl in enumerate(flags):
            rows.append(_box(0.5 + 0.6 * j, 0.8, 0.25, (0.25, 0.2, 0.2),
                             quat=_quat(rng.normal(size=3), 25), **fl))
            rows.append(_sphere(0.5 + 0.6 * j, 2.8, 0.3, 0.25, **fl))
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (verts, tris), ((0.0, 0.0), 2.0, 3, 2, 8), ground_z=0.0))
    if case in ("mixed_present", "present_subset", "ring_ties"):
        cube = [[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)]
        octa = [[0.6, 0, 0], [-0.6, 0, 0], [0, 0.6, 0], [0, -0.6, 0], [0, 0, 0.6], [0, 0, -0.6]]
        repeat = cube[:4] + [cube[0]] + cube[4:]
        ang = np.arange(16) * (2 * np.pi / 16)
        prism = [[0.4 * np.cos(a), 0.4 * np.sin(a), z] for z in (-0.3, 0.3) for a in ang]
        hulls = (cube, octa, repeat, prism)
    if case in ("mixed_present", "present_subset"):
        n = 12
        xs = np.linspace(-6.0, 6.0, n + 1, dtype=np.float32)
        gz = rng.uniform(-0.05, 0.35, (n + 1, n + 1)).astype(np.float32)
        gv = np.array([[x, y, gz[i, j]] for i, x in enumerate(xs) for j, y in enumerate(xs)],
                      np.float32)
        q = np.arange(n * n)
        v00 = (q // n) * (n + 1) + q % n
        tris = np.concatenate([np.stack([v00, v00 + n + 1, v00 + n + 2], 1),
                               np.stack([v00, v00 + n + 2, v00 + 1], 1)]).astype(np.int32)
        types = (1, 3) if case == "present_subset" else (0, 1, 2, 3)
        rows = []
        for j in range(28):
            st = types[j % len(types)]
            prm = {0: [rng.uniform(0.2, 0.4)], 1: list(rng.uniform(0.15, 0.4, 3)),
                   2: [rng.uniform(0.1, 0.25), rng.uniform(0.1, 0.3)],
                   3: [j % 4, 0.5, 0.5, 0.5]}[st]
            rows.append(dict(st=st, prm=prm, pos=(*rng.uniform(-5.5, 5.5, 2),
                                                  rng.uniform(0.0, 0.9)),
                             quat=_quat(rng.normal(size=3), rng.uniform(0, 180)),
                             awake=j % 9 != 4))
        h = rng.uniform(-0.2, 0.2, (7, 7)).astype(np.float32)
        present = (False, True, False, True) if case == "present_subset" else (True,) * 4
        return StaticScene(_static_bodies(rows, seed=seed), _static_world(
            (gv, tris), ((-6.0, -6.0), 1.5, 8, 8, 32), heightfield=(h, (-6.0, -6.0), 2.0),
            hulls=hulls), present=present)
    if case != "ring_ties":
        raise ValueError(f"unknown static case {case!r}")
    verts, tris = _tris_of(_flat_tri(-6, -6, 6, 6, 0.0), [[6, -6, 0.0], [6, 6, 0.0], [-6, 6, 0.0]])
    half = (0.5, 0.6, 0.5, 0.3)
    turns = ((0.0, 0.0, 0.0, 1.0), (1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0),
             (0.0, 0.0, 1.0, 0.0), _quat((0, 0, 1), 90), _quat((1, 0, 0), 90))
    rows = [dict(st=3, prm=[h, 0.5, 0.5, 0.5], pos=(-4.5 + 1.6 * t, -4.5 + 2.4 * h, half[h]),
                 quat=turns[t]) for h in range(4) for t in range(6)]
    return StaticScene(_static_bodies(rows, seed=seed), _static_world(
        (verts, tris), ((-6.0, -6.0), 3.0, 4, 4, 8), ground_z=None, hulls=hulls),
        present=(False, False, False, True))


def static_inputs(scene: StaticScene, k: int, device):
    """The port's ``static_contacts`` arguments for ``scene`` with K = ``k``
    on ``device``."""
    from substrata_tpu_torch import convert
    body = convert.body_state_from_numpy(scene.bodies, device=device)
    sw = convert.static_world_from_numpy(scene.world, device=device)
    return (body, sw.heightfield, sw.has_heightfield, k, scene.present, sw.hulls, sw.trimesh,
            scene.max_tri_candidates)


# ---------------------------------------------------------------------------
# KQ and KC: contact-solve scenes.
# ---------------------------------------------------------------------------

SOLVE_CASES = ("cpb_limit", "asleep", "invalid_rows", "gather_safe", "static_only",
               "pairs_only", "wm1", "wm4", "cache")
SOLVE_N, SOLVE_K, SOLVE_Q, SOLVE_CPB = 64, 4, 48, 8


@dataclasses.dataclass
class SolveScene:
    """One solve's inputs (numpy): the bodies (BodyState fields), the static
    rows [N K] and pair rows [Q wm] (Contacts fields), the manifold width,
    the incidence table's entry occupancy, and the [H, 5] warm-start cache
    (rows keyed as the solve keys them)."""
    bodies: dict
    static: dict
    pair: dict
    wm: int
    occupied: np.ndarray
    cache: np.ndarray


def _solve_rows(rng, a, b, count, pos, pts_up):
    """``count`` contact rows of bodies ``a`` (against ``b``): points near
    the bodies, unit normals (upward for static rows), seeded depths."""
    base = pos[np.maximum(a, 0)]
    point = (base + rng.uniform(-0.5, 0.5, (count, 3))).astype(np.float32)
    nrm = rng.normal(size=(count, 3))
    if pts_up:
        nrm[:, 2] = np.abs(nrm[:, 2]) + 2.0
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    return dict(a=a.astype(np.int32), b=b.astype(np.int32), point=point, normal=nrm,
                penetration=rng.uniform(-0.03, 0.12, count).astype(np.float32),
                valid=rng.random(count) < 0.85,
                friction=rng.uniform(0.2, 0.9, count).astype(np.float32),
                restitution=rng.uniform(0.0, 0.4, count).astype(np.float32))


def solve_scene(case: str, seed: int = 0) -> SolveScene:
    """The inputs of one hard solve case, N = 64 body slots (48 alive,
    dynamic, tumbling), K = 4 static rows a body, Q = 48 pair entries,
    CPB = 8 (every case shares these shapes, so the reference compiles
    each layout once):

    - ``cpb_limit``: one body in 9 entries (one past the table's CPB),
      another in exactly 8;
    - ``asleep``: every other body asleep (inverse mass and inertia 0 in
      the solve);
    - ``invalid_rows``: rows 1 and 2 of every body's K, and 1 and 3 of
      every entry's wm, invalid;
    - ``gather_safe``: a quarter of the entries with a or b at -1 (empty,
      invalid, read at slot 0);
    - ``static_only``, ``pairs_only``: no valid pair rows, no valid static
      rows;
    - ``wm1``, ``wm4``: manifold widths 1 (the compacted layout) and 4;
    - ``cache``: a 64-slot cache for ~370 rows: hits, misses, and slots
      that several rows hash to (the last writer's identity kept, the
      others miss).
    Elsewhere the cache (1,024 slots) holds half the valid rows' impulses.
    """
    from substrata_tpu_torch.kernels.solve_setup import cache_hash
    if case not in SOLVE_CASES:
        raise ValueError(f"unknown solve case {case!r}")
    rng = np.random.default_rng(seed + SOLVE_CASES.index(case))
    from substrata_tpu_torch.physics import state
    n, k, q, cpb = SOLVE_N, SOLVE_K, SOLVE_Q, SOLVE_CPB
    wm = 1 if case == "wm1" else 4
    a = {f: v.numpy().copy() for f, v in vars(state.zero_body_state(n, device="cpu")).items()}
    alive = np.arange(n) < 48
    a["pos"][:48] = rng.uniform((-4, -4, 0.2), (4, 4, 3), (48, 3))
    quat = rng.normal(size=(48, 4))
    a["quat"][:48] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    a["linvel"][:48] = rng.normal(0, 1.5, (48, 3))
    a["angvel"][:48] = rng.normal(0, 2.0, (48, 3))
    a["inv_mass"][:48] = rng.uniform(0.2, 2.0, 48)
    a["inv_inertia"][:48] = rng.uniform(0.3, 5.0, (48, 3))
    a["alive"][:] = alive
    a["awake"][:] = alive & ((np.arange(n) % 2 == 0) if case == "asleep" else True)
    a["motion_type"][:48] = 2
    a["shape_type"][:48] = 1
    a["shape_params"][:48, :3] = 0.4
    a["bound_radius"][:48] = 0.7
    pos = a["pos"]

    sa = np.repeat(np.where(alive, np.arange(n), -1), k)
    st = _solve_rows(rng, sa, np.full(n * k, -1), n * k, pos, True)
    st["valid"] &= sa >= 0
    st["key"] = np.tile(np.arange(1, k + 1), n).astype(np.int32)

    ea = rng.integers(0, 48, q)
    eb = (ea + rng.integers(1, 48, q)) % 48
    if case == "cpb_limit":
        ea[:9], eb[:9] = 0, np.arange(1, 10)
        ea[9:17], eb[9:17] = 10, np.arange(11, 19)
    if case == "gather_safe":
        ea[: q // 8] = -1
        eb[q // 8: q // 4] = -1
    if case == "static_only":
        ea[:] = -1
        eb[:] = -1
    pa, pb = np.repeat(ea, wm), np.repeat(eb, wm)
    pr = _solve_rows(rng, pa, pb, q * wm, pos, False)
    pr["valid"] &= (pa >= 0) & (pb >= 0)
    slot = np.tile(np.arange(wm), q)
    pr["key"] = np.where(pa >= 0, np.maximum(pb, 0) * 4 + slot + 9, 0).astype(np.int32)
    if case == "invalid_rows":
        st["valid"] &= ~np.isin(np.tile(np.arange(k), n), (1, 2))
        pr["valid"] &= ~np.isin(slot, (1, 3))
    if case == "pairs_only":
        st["valid"][:] = False
    occupied = (ea >= 0) if wm > 1 else (pr["valid"] & (ea >= 0))

    size = 64 if case == "cache" else 1024
    cache = np.zeros((size, 5), np.float32)
    cache[:, :2].view(np.int32)[:, 0] = -1
    rows_a = np.concatenate([st["a"], pr["a"]])
    rows_key = np.concatenate([st["key"], pr["key"]])
    rows_ok = np.concatenate([st["valid"], pr["valid"]]) & (rows_a >= 0)
    h = cache_hash(torch.as_tensor(np.maximum(rows_a, 0)), torch.as_tensor(rows_key),
                   size).numpy()
    keep = rows_ok & (rng.random(rows_ok.shape[0]) < (0.9 if case == "cache" else 0.5))
    for r in np.flatnonzero(keep):
        cache[h[r], :2].view(np.int32)[:] = (rows_a[r], rows_key[r])
        cache[h[r], 2:] = (rng.uniform(0, 0.3), *rng.uniform(-0.1, 0.1, 2))
    return SolveScene(a, st, pr, wm, occupied, cache)


def solve_inputs(scene: SolveScene, device):
    """The port's solve arguments for ``scene`` on ``device``: (body,
    static Contacts, pair Contacts, table, sign, cache data, wm); the table
    from KT's twin on the CPU."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.physics.narrowphase import CONTACT_FIELDS, Contacts
    body = convert.body_state_from_numpy(scene.bodies, device=device)
    st, pr = (Contacts(*(torch.as_tensor(np.ascontiguousarray(c[f]), device=device)
                         for f in CONTACT_FIELDS)) for c in (scene.static, scene.pair))
    wm = scene.wm
    e_a = torch.as_tensor(scene.pair["a"][::wm].copy())
    e_b = torch.as_tensor(scene.pair["b"][::wm].copy())
    table, sign, _ = layout.incidence_plain(e_a, e_b, torch.as_tensor(scene.occupied),
                                            SOLVE_N, SOLVE_CPB)
    return (body, st, pr, table.to(device), sign.to(device),
            torch.as_tensor(scene.cache, device=device), wm)


# ---------------------------------------------------------------------------
# Rotations (maths/quat.py:rotate_vec, csrc/common.cuh:rotate_vec).
# ---------------------------------------------------------------------------

def rotation_corpus(seed: int = 0, n: int = 4096):
    """(q [M, 4], v [M, 3]) float32: random unit quaternions on random
    vectors, near-identity turns (1e-6 to 1e-2 rad), 180-degree turns (w =
    0, about random and about the coordinate axes), and the axis-aligned
    vectors (+-e_k, and e_k scaled) under every kind of turn."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    q_rand = unit(rng.normal(size=(n, 4)))
    axis = unit(rng.normal(size=(n, 3)))
    half = np.exp(rng.uniform(np.log(1e-6), np.log(1e-2), n)) / 2
    q_near = np.concatenate([axis * np.sin(half)[:, None], np.cos(half)[:, None]], 1)
    q_half = np.concatenate([np.concatenate([unit(rng.normal(size=(n - 3, 3))), np.eye(3)]),
                             np.zeros((n, 1))], 1)
    qs = np.concatenate([q_rand, q_near, q_half])
    vs = rng.normal(0, 3, qs.shape[:1] + (3,))
    basis = np.concatenate([np.eye(3), -np.eye(3), 7.5 * np.eye(3)])
    pick = rng.integers(0, qs.shape[0], 3 * n)
    q_ax = qs[pick]
    v_ax = basis[rng.integers(0, basis.shape[0], 3 * n)]
    return (np.concatenate([qs, q_ax]).astype(np.float32),
            np.concatenate([vs, v_ax]).astype(np.float32))


CROSS_CORPUS = ("near_parallel", "cancelling", "tangent_edge", "random")


def cross_corpus(kind: str, seed: int = 0, n: int = 4096):
    """(a [n, 3], b [n, 3]) float32 on which a plain cross or dot product
    and the one XLA contracts part: ``near_parallel`` (b a scaled copy of a
    turned by 1e-9 to 1 of |a|, scales from 1e-3 to 1e3), ``cancelling``
    (b a rounded multiple of a, so every component of a x b cancels to a
    few ulps), ``tangent_edge`` (unit a with |a_x| within 1e-6 of 0.9 and
    near the coordinate axes, the tangent basis's switch; b random) and
    ``random``."""
    rng = np.random.default_rng(seed + CROSS_CORPUS.index(kind))

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    scale = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (n, 1)))
    a = rng.normal(size=(n, 3)) * scale
    if kind == "near_parallel":
        turn = np.exp(rng.uniform(np.log(1e-9), 0.0, (n, 1)))
        b = a * rng.uniform(0.5, 2.0, (n, 1)) + unit(rng.normal(size=(n, 3))) * turn * np.abs(a)
    elif kind == "cancelling":
        a = a.astype(np.float32)
        b = a * rng.uniform(0.1, 10.0, (n, 1)).astype(np.float32)
    elif kind == "tangent_edge":
        m = n // 2
        x = 0.9 + rng.uniform(-1e-6, 1e-6, m) * rng.choice([1.0, 0.0], m)
        yz = unit(rng.normal(size=(m, 2))) * np.sqrt(1.0 - x * x)[:, None]
        edge = np.concatenate([x[:, None], yz], 1) * rng.choice([-1.0, 1.0], (m, 1))
        axes = np.eye(3)[rng.integers(0, 3, n - m)] * rng.choice([-1.0, 1.0], (n - m, 1))
        near = unit(axes + rng.normal(size=(n - m, 3)) * np.exp(rng.uniform(-16, -2, (n - m, 1))))
        a = np.concatenate([edge, near])
        b = rng.normal(size=(n, 3)) * scale
    else:
        b = rng.normal(size=(n, 3)) * scale
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


# ---------------------------------------------------------------------------
# KS: pair-finder scenes.
# ---------------------------------------------------------------------------

PAIR_CASES = ("score_ties", "hash_collision", "row_overflow", "max_pairs_overflow",
              "oversize_1", "oversize_65", "static_asleep", "none_alive", "nan_velocity",
              "all_still", "ppb_1", "ppb_16")
PAIR_N = 256
_PAIR_CFG = dict(capacity=PAIR_N, max_pairs=2048, grid_dim=16, cell_size=1.4, cell_capacity=6,
                 pairs_per_body=10, pair_rebuild_interval=6)


@dataclasses.dataclass
class PairScene:
    """One pair finder's inputs (numpy): the bodies (BodyState fields), the
    SimConfig's keyword arguments and the oversize pass's flag."""
    bodies: dict
    cfg: dict
    has_oversize: bool


def _shape_bound(st, prm):
    """A bound radius for shape ``st`` with params ``prm`` (sphere r, box
    half-extents, capsule r + half height, hull 0.5)."""
    if st == 0:
        return float(prm[0])
    if st == 1:
        return float(np.float32(np.linalg.norm(np.asarray(prm[:3], np.float64))))
    if st == 2:
        return float(prm[0] + prm[1])
    return 0.5


def _random_shape(rng, scale=1.0):
    st = int(rng.integers(0, 4))
    prm = np.zeros(4, np.float32)
    if st == 0:
        prm[0] = rng.uniform(0.25, 0.55) * scale
    elif st == 1:
        prm[:3] = rng.uniform(0.15, 0.35, 3) * scale
    elif st == 2:
        prm[0], prm[1] = rng.uniform(0.15, 0.3) * scale, rng.uniform(0.1, 0.3) * scale
    return st, prm


def _pair_bodies(pos, shapes, rng, alive=None, motion=None, layer=None, awake=None,
                speed=2.0, capacity=None):
    """BodyState fields (numpy) of bodies at ``pos`` [M, 3] with ``shapes``
    [(type, params)]: dynamic, moving, awake, random velocities up to
    ``speed`` unless given; slots past M (to ``capacity``) dead; the slot
    order shuffled."""
    from substrata_tpu_torch.physics import state
    m = pos.shape[0]
    n = capacity or m
    a = {k: v.numpy().copy() for k, v in vars(state.zero_body_state(n, device="cpu")).items()}
    perm = rng.permutation(n)[:m]
    for k, (st, prm) in enumerate(shapes):
        a["shape_type"][perm[k]] = st
        a["shape_params"][perm[k]] = prm
        a["bound_radius"][perm[k]] = _shape_bound(st, prm)
    a["pos"][perm] = pos
    a["linvel"][perm] = rng.uniform(-speed, speed, (m, 3))
    a["alive"][perm] = True if alive is None else alive
    a["motion_type"][perm] = 2 if motion is None else motion
    a["layer"][perm] = 1 if layer is None else layer
    a["awake"][perm] = True if awake is None else awake
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def _lattice2d(side, spacing, z, offset=0.25, jitter=0.0, rng=None):
    k = np.arange(side * side)
    pos = np.stack([k % side * spacing + offset, k // side * spacing + offset,
                    np.full(k.shape, z)], axis=1).astype(np.float32)
    if jitter:
        pos[:, :2] += rng.uniform(-jitter, jitter, (len(k), 2)).astype(np.float32)
    return pos


def _pile(rng, m, extent, z_layers=2, scale=1.0):
    pos = np.stack([rng.uniform(0, extent, m), rng.uniform(0, extent, m),
                    rng.uniform(0.3, 0.3 + 1.4 * z_layers, m)], axis=1).astype(np.float32)
    return pos, [_random_shape(rng, scale) for _ in range(m)]


def pair_scene(case: str, seed: int = 0) -> PairScene:
    """The inputs of one hard pair-finder case, 256 body slots, 1.4 m
    cells, 6 a bucket:

    - ``score_ties``: a 16 x 16 lattice of equal spheres at exactly 1 m
      spacing, one speed for all (so every margin is the same): equal
      scores, and pairs_per_body 3 cuts between two equal diagonals, so
      the column order decides;
    - ``hash_collision``: 4 buckets (grid 2), so the 14 stencil cells of a
      body list one neighbour several times;
    - ``row_overflow``: spheres at 0.7 m whose 4 forward neighbours all
      touch, pairs_per_body 2: tight candidates dropped;
    - ``max_pairs_overflow``: a jittered lattice of mixed shapes with 64
      pair slots: the compaction truncates;
    - ``oversize_1``, ``oversize_65``: 1 and 65 bodies wider than a cell
      among small ones (the oversize pass lists 64);
    - ``static_asleep``: static, kinematic, asleep, awake and
      non-collidable bodies mixed (static-static pairs dropped);
    - ``none_alive``: no body alive;
    - ``nan_velocity``: a pile with one NaN velocity (the rebuild's
      window and that body's margin NaN);
    - ``all_still``: a pile at rest (the rebuild's window at its cap);
    - ``ppb_1``, ``ppb_16``: a dense pile at pairs_per_body 1 and 16.
    """
    rng = np.random.default_rng(seed)
    cfg = dict(_PAIR_CFG)
    has_os = False
    n = PAIR_N
    if case == "score_ties":
        pos = _lattice2d(16, 1.0, 0.75)
        b = _pair_bodies(pos, [(0, np.array([0.7, 0, 0, 0], np.float32))] * len(pos), rng)
        b["linvel"][:] = np.array([0.5, 0.0, 0.0], np.float32)
        cfg["pairs_per_body"] = 3
    elif case == "hash_collision":
        pos, shp = _pile(rng, 16, 3.6, z_layers=1)
        b = _pair_bodies(pos, shp, rng, capacity=n)
        cfg["grid_dim"] = 2
    elif case == "row_overflow":
        pos = _lattice2d(16, 0.7, 0.5)
        b = _pair_bodies(pos, [(0, np.array([0.5, 0, 0, 0], np.float32))] * len(pos), rng)
        cfg["pairs_per_body"] = 2
    elif case == "max_pairs_overflow":
        pos = _lattice2d(16, 0.8, 0.5, jitter=0.1, rng=rng)
        b = _pair_bodies(pos, [_random_shape(rng) for _ in pos], rng)
        cfg["max_pairs"] = 64
    elif case in ("oversize_1", "oversize_65"):
        big = 1 if case == "oversize_1" else 65
        pos, shp = _pile(rng, n - big, 16.0)
        bpos = np.stack([rng.uniform(0, 16, big), rng.uniform(0, 16, big),
                         rng.uniform(0.5, 2.5, big)], axis=1).astype(np.float32)
        bshp = [(0, np.array([rng.uniform(0.8, 1.6), 0, 0, 0], np.float32)) for _ in range(big)]
        b = _pair_bodies(np.concatenate([pos, bpos]), shp + bshp, rng)
        has_os = True
    elif case == "static_asleep":
        pos, shp = _pile(rng, 200, 10.0)
        motion = rng.integers(0, 3, 200)
        layer = np.where(motion == 0, 0, 1)
        layer = np.where(rng.random(200) < 0.1, layer + 2, layer)
        awake = (motion != 0) & (rng.random(200) < 0.5)
        b = _pair_bodies(pos, shp, rng, motion=motion, layer=layer, awake=awake, capacity=n)
    elif case == "none_alive":
        pos, shp = _pile(rng, n, 12.0)
        b = _pair_bodies(pos, shp, rng, alive=False)
    elif case in ("nan_velocity", "all_still"):
        pos, shp = _pile(rng, 220, 10.0)
        b = _pair_bodies(pos, shp, rng, capacity=n, speed=0.0 if case == "all_still" else 3.0)
        if case == "nan_velocity":
            moving = np.flatnonzero(b["alive"])
            b["linvel"][moving[len(moving) // 2], 1] = np.nan
    elif case in ("ppb_1", "ppb_16"):
        pos, shp = _pile(rng, n, 7.0, z_layers=2)
        b = _pair_bodies(pos, shp, rng)
        cfg["pairs_per_body"] = 1 if case == "ppb_1" else 16
    else:
        raise ValueError(f"unknown pair case {case!r}")
    return PairScene(bodies=b, cfg=cfg, has_oversize=has_os)


def pair_world(fields, cell_size: float = 1.4, seed: int = 0, max_bound: float | None = None):
    """BodyState fields (numpy) from ``cell_bodies``'s fields: the same
    positions and flags, the bound radii (scaled from [0, cell_size] to [0,
    ``max_bound``] where given: 0.6928 is the bench's 0.4 m box); spheres of
    that radius (boxes and capsules inside it for a third each), random
    velocities; a non-collidable body on a non-colliding layer."""
    from substrata_tpu_torch.physics import state
    rng = np.random.default_rng(seed)
    n = fields["pos"].shape[0]
    a = {k: v.numpy().copy() for k, v in vars(state.zero_body_state(n, device="cpu")).items()}
    for k in ("pos", "alive", "awake", "motion_type"):
        a[k][:] = fields[k]
    r = fields["bound_radius"]
    if max_bound is not None:
        r = (r * np.float32(max_bound / cell_size)).astype(np.float32)
    a["bound_radius"][:] = r
    st = rng.integers(0, 3, n).astype(np.int32)
    a["shape_type"][:] = st
    a["shape_params"][:, 0] = np.where(st == 2, 0.5 * r, np.where(st == 1, 0.5 * r, r))
    a["shape_params"][:, 1] = np.where(st == 0, 0.0, 0.5 * r)
    a["shape_params"][:, 2] = np.where(st == 1, 0.5 * r, 0.0)
    a["layer"][:] = np.where(fields["collidable"], np.where(fields["motion_type"] == 0, 0, 1),
                             3).astype(np.int32)
    a["linvel"][:] = rng.uniform(-2.0, 2.0, (n, 3))
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def pair_inputs(scene: PairScene, device):
    """(BodyState, SimConfig, has_oversize) of ``scene`` on ``device``."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.physics.state import SimConfig
    return (convert.body_state_from_numpy(scene.bodies, device=device), SimConfig(**scene.cfg),
            scene.has_oversize)


# ---------------------------------------------------------------------------
# KG: downmix scenes.
# ---------------------------------------------------------------------------

DOWNMIX_CASES = ("s1_b800", "s33_b256", "s64_b800", "s256_b800", "s256_b256", "s1024_b1024",
                 "s256_b1", "wrap", "delay_d_minus_1", "no_room")
DOWNMIX_D = 8192


@dataclasses.dataclass
class DownmixScene:
    """KG's inputs (numpy): the [S, B] left, right and send blocks, the
    master volume, and the room (4 delay lines of D, the write index, the
    line delays, feedback and wet), or None without one."""
    wl: np.ndarray
    wr: np.ndarray
    ws: np.ndarray
    master_volume: float
    room: dict | None


def downmix_scene(case: str, seed: int = 0) -> DownmixScene:
    """``s{S}_b{B}``: S sources, B frames (S = 64 is one shard of four of
    256; 1,024 sources past a block's 256), the ring's write index at
    random, the delays the room's own; ``wrap``: the write index at D - 1,
    so the ring wraps at the block's second frame; ``delay_d_minus_1``: a
    line delayed D - 1 (it reads what the next frame writes); ``no_room``:
    256 sources, 800 frames, no room.  Samples are spread over +-0.05 with
    a few loud ones, so a frame's sum reaches past the clip."""
    rng = np.random.default_rng(seed)
    if case.startswith("s"):
        s, b = (int(x[1:]) for x in case.split("_"))
    else:
        s, b = 256, 800
    def block():
        x = rng.normal(0.0, 0.02, (s, b)).astype(np.float32)
        loud = rng.random((s, b)) < 0.01
        return np.where(loud, rng.uniform(-1, 1, (s, b)), x).astype(np.float32)
    wl, wr, ws = block(), block(), block()
    room = dict(delay_lines=rng.normal(0.0, 0.1, (4, DOWNMIX_D)).astype(np.float32),
                write_idx=np.int32(rng.integers(0, DOWNMIX_D)),
                delays=np.array([1931, 2729, 4519, 8191], np.int32),
                feedback=np.float32(0.72), wet=np.float32(0.35))
    if case == "wrap":
        room["write_idx"] = np.int32(DOWNMIX_D - 1)
    elif case == "delay_d_minus_1":
        room["delays"] = np.array([1931, DOWNMIX_D - 1, 1024, 8000], np.int32)
    elif case == "no_room":
        room = None
    elif not case.startswith("s"):
        raise ValueError(f"unknown downmix case {case!r}")
    return DownmixScene(wl=wl, wr=wr, ws=ws, master_volume=0.8, room=room)


def downmix_inputs(scene: DownmixScene, device):
    """``audio_downmix_reverb``'s arguments for ``scene`` on ``device``."""
    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)
    mv = torch.tensor(scene.master_volume, dtype=torch.float32, device=device)
    if scene.room is None:
        return (t(scene.wl), t(scene.wr), None, mv)
    r = scene.room
    return (t(scene.wl), t(scene.wr), t(scene.ws), mv, t(r["delay_lines"]), t(r["write_idx"]),
            t(r["delays"]), t(r["feedback"]), t(r["wet"]))


# ---------------------------------------------------------------------------
# KN: digest scenes.
# ---------------------------------------------------------------------------

DIGEST_CASES = ("none_set", "exactly_full", "one_over", "all_set", "edges", "ragged_n",
                "p65536")


@dataclasses.dataclass
class DigestScene:
    """KN's inputs (numpy): the bodies (BodyState fields; the transform
    block reads pos, quat, linvel, angvel and underwater), the step's
    events (the StepEvents fields) and the scalars num_contacts, num_awake
    and the pair cache's steps_left."""
    bodies: dict
    events: dict
    scalars: tuple


def digest_scene(case: str, seed: int = 0) -> DigestScene:
    """The inputs of one hard digest case, N = 2,048 bodies and P = 4,096
    pair slots unless named:

    - ``none_set``: no entry set in any mask;
    - ``exactly_full``: 64 set in each body mask, 128 touching, at random
      slots: every class fills its digest slots and none overflows;
    - ``one_over``: 65 and 129, the overflow that sends the host to the
      bit words;
    - ``all_set``: every entry set;
    - ``edges``: set entries only at word and tile edges (slots 31, 32,
      255, 256, 1023, 1024 and the last);
    - ``ragged_n``: N = 1,013 and P = 2,001 (neither a multiple of 32), 30%
      of each mask set;
    - ``p65536``: the bench's N = 10,240 with P = 65,536 pair slots, 1% of
      each body mask and 5% of the pairs set.

    Pair ids are random in [-1, N); body poses and velocities are random,
    half the bodies underwater."""
    rng = np.random.default_rng(seed)
    n, p = {"ragged_n": (1013, 2001), "p65536": (10_240, 65_536)}.get(case, (2048, 4096))

    def chosen(length, k):
        m = np.zeros(length, bool)
        m[rng.choice(length, k, replace=False)] = True
        return m

    def edge_mask(length):
        m = np.zeros(length, bool)
        m[[s for s in (31, 32, 255, 256, 1023, 1024) if s < length] + [length - 1]] = True
        return m

    def mask(length, size):
        if case == "none_set":
            return np.zeros(length, bool)
        if case == "exactly_full":
            return chosen(length, size)
        if case == "one_over":
            return chosen(length, size + 1)
        if case == "all_set":
            return np.ones(length, bool)
        if case == "edges":
            return edge_mask(length)
        if case == "ragged_n":
            return rng.random(length) < 0.3
        if case == "p65536":
            return rng.random(length) < (0.05 if size == 128 else 0.01)
        raise ValueError(f"unknown digest case {case!r}")

    events = dict(newly_awake=mask(n, 64), newly_asleep=mask(n, 64),
                  entered_water=mask(n, 64), contact_touching=mask(p, 128),
                  contact_pair_a=rng.integers(-1, n, p).astype(np.int32),
                  contact_pair_b=rng.integers(-1, n, p).astype(np.int32),
                  num_pairs=np.int32(rng.integers(0, p)),
                  broadphase_overflow=np.int32(rng.integers(0, 5)))
    from substrata_tpu_torch.physics import state
    a = {k: v.numpy().copy() for k, v in vars(state.zero_body_state(n, device="cpu")).items()}
    a["pos"][:] = rng.uniform(-50, 50, (n, 3))
    q = rng.normal(size=(n, 4))
    a["quat"][:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    a["linvel"][:] = rng.normal(0.0, 2.0, (n, 3))
    a["angvel"][:] = rng.normal(0.0, 2.0, (n, 3))
    a["underwater"][:] = rng.random(n) < 0.5
    bodies = {k: np.ascontiguousarray(v) for k, v in a.items()}
    scalars = tuple(np.int32(v) for v in (rng.integers(0, 4 * p), rng.integers(0, n),
                                          rng.integers(0, 6)))
    return DigestScene(bodies=bodies, events=events, scalars=scalars)


def digest_inputs(scene: DigestScene, device):
    """``digest_tblock``'s arguments for ``scene`` on ``device``: (events,
    num_contacts, num_awake, steps_left, state)."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.physics.step import StepEvents
    ev = StepEvents(**{k: torch.as_tensor(np.asarray(v), device=device)
                       for k, v in scene.events.items()})
    scal = [torch.as_tensor(v, device=device) for v in scene.scalars]
    return (ev, *scal, convert.body_state_from_numpy(scene.bodies, device=device))


# ---------------------------------------------------------------------------
# KF: spatialise scenes.
# ---------------------------------------------------------------------------

SPATIALISE_CASES = ("b1", "b255", "b256", "b800", "b1024", "t1", "alpha_one", "alpha_tiny",
                    "no_send", "no_hrtf")
SPATIALISE_S = 48
SPATIALISE_BANK = (5, 3)     # azimuth x elevation rows of the scenes' HRIR bank


@dataclasses.dataclass
class SpatialiseScene:
    """KF's inputs (numpy): ``arrays`` by ``audio_spatialise``'s argument
    names (``send_gain`` None without a send), ``use_hrtf``, and the
    folded epilogue's inputs (``epilogue``, by ``EPILOGUE_FIELDS``)."""
    arrays: dict
    use_hrtf: bool
    epilogue: dict


def spatialise_scene(case: str, seed: int = 0) -> SpatialiseScene:
    """48 sources, B = 800 frames and T = 64 taps unless named: ``b{B}``
    (1, 255, 256, 800, 1,024 frames: one frame, a block that is not a
    multiple of the FIR's 4-frame runs, the client's render block, the
    tick, the kernel's largest), ``t1`` (one tap, no history; B = 256),
    ``alpha_one`` (alpha = 1: the low-pass passes its input through),
    ``alpha_tiny`` (alpha = 1e-4: it barely moves from its state),
    ``no_send`` and ``no_hrtf``.  In every case about half the sources
    use the low-pass, a quarter are not spatial (the pan path), alpha is
    one of the mix's three values elsewhere, and samples are spread over
    +-0.3 with a few loud ones.  The epilogue's inputs come from a stream
    of their own (``_epilogue_fields``), so KF's stay as they were."""
    rng = np.random.default_rng(seed)
    s = SPATIALISE_S
    b = int(case[1:]) if case.startswith("b") else (256 if case == "t1" else 800)
    t = 1 if case == "t1" else 64
    if case not in SPATIALISE_CASES:
        raise ValueError(f"unknown spatialise case {case!r}")
    x = rng.normal(0.0, 0.1, (s, b))
    loud = rng.random((s, b)) < 0.01
    samples = np.where(loud, rng.uniform(-1, 1, (s, b)), x).astype(np.float32)
    if case == "alpha_one":
        alpha = np.ones(s, np.float32)
    elif case == "alpha_tiny":
        alpha = np.full(s, 1e-4, np.float32)
    else:
        alpha = rng.choice(np.array([0.1024, 0.3491, 1.0], np.float32), s)
    na, ne = SPATIALISE_BANK
    bank = rng.normal(0.0, 0.2, (na, ne, 2, t)).astype(np.float32)
    f32 = np.float32
    arrays = dict(
        samples=samples, lp_state=rng.normal(0.0, 0.1, s).astype(f32), alpha=alpha,
        use_lp=rng.random(s) < 0.5, spatial=rng.random(s) < 0.75,
        hrir_hist=rng.normal(0.0, 0.1, (s, t - 1)).astype(f32), bank=bank,
        dir_idx=rng.integers(0, na * ne, s).astype(np.int32),
        prev_gl=rng.uniform(0, 1, s).astype(f32), prev_gr=rng.uniform(0, 1, s).astype(f32),
        gl=rng.uniform(0, 1, s).astype(f32), gr=rng.uniform(0, 1, s).astype(f32),
        ramp=np.linspace(0.0, 1.0, b, dtype=f32), gain=rng.uniform(0, 1, s).astype(f32),
        send_gain=None if case == "no_send" else rng.uniform(0, 1, s).astype(f32))
    return SpatialiseScene(arrays=arrays, use_hrtf=case != "no_hrtf",
                           epilogue=_epilogue_fields(np.random.default_rng([seed, 1]), s, 3))


SPATIALISE_ARGS = ("samples", "lp_state", "alpha", "use_lp", "spatial", "hrir_hist", "bank",
                   "dir_idx", "prev_gl", "prev_gr", "gl", "gr", "ramp", "gain", "send_gain")


def spatialise_inputs(scene: SpatialiseScene, device):
    """``audio_spatialise``'s arguments for ``scene`` on ``device``, the
    epilogue's tuple last."""
    a = scene.arrays
    return tuple(None if a[k] is None else torch.as_tensor(a[k], device=device)
                 for k in SPATIALISE_ARGS) + (scene.use_hrtf, tuple(
                     torch.as_tensor(scene.epilogue[k], device=device) for k in EPILOGUE_FIELDS))


# ---------------------------------------------------------------------------
# KJ: vehicle scenes.
# ---------------------------------------------------------------------------

VEHICLE_CASES = ("types", "airborne", "wheels_2_4", "shift_edges", "input_edges", "unflip",
                 "prop_waterline", "slow", "righting", "v1", "v33")
VEHICLE_WATER_Z = 0.5
_CAR_WHEELS = ((-0.8, 1.2, -0.2), (0.8, 1.2, -0.2), (-0.8, -1.2, -0.2), (0.8, -1.2, -0.2))
_BIKE_WHEELS = ((0.0, 0.9, -0.4), (0.0, -0.9, -0.4))


@dataclasses.dataclass
class VehicleScene:
    """KJ's inputs (numpy): ``veh`` (the VehicleArrays fields by name),
    ``inp`` (the VehicleInputs fields), ``chassis`` (pos, quat, lin, ang,
    mass, iw: the chassis rows the force models read), ``hits`` (hit_t [V,
    4], hit_n [V, 4, 3], hit_ok [V, 4]), the water level and dt."""
    veh: dict
    inp: dict
    chassis: tuple
    hits: tuple
    water_z: float
    dt: float


def _quat_axis(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]]).astype(np.float32)


def _rpm_speeds(ratio, rad, target):
    """Two chassis speeds (float32) whose engine rpm, as KJ rounds it
    (|speed| / rad * |ratio * 3.42| * rpm per rad/s), lies on ``target``
    or just below it and just above it."""
    f = np.float32
    r = f(f(ratio) * f(3.42))
    rpm_k = f(60.0 / (2.0 * np.pi))

    def rpm(s):
        return f(f(f(abs(s) / f(rad)) * abs(r)) * rpm_k)
    s = f(target / (abs(r) * rpm_k) * rad)
    while rpm(s) > target:
        s = np.nextafter(s, f(0))
    while rpm(np.nextafter(s, f(np.inf))) <= target:
        s = np.nextafter(s, f(np.inf))
    return s, np.nextafter(s, f(np.inf))


def vehicle_scene(case: str, seed: int = 0) -> VehicleScene:
    """The inputs of one hard vehicle case, V = 8 unless named:

    - ``types``: each vehicle type active and inactive, random state;
    - ``airborne``: every wheel's ray missed (hit_ok False, t at the ray's
      length);
    - ``wheels_2_4``: cars and bikes with 2 and with 4 wheels;
    - ``shift_edges``: upright cars and bikes rolling at the speeds whose
      rpm is on (or just below) and just above the shift-up and
      shift-down rpm, shift timers at 0 and at the smallest normal float;
    - ``input_edges``: forward input at +-0.01 and one float past each,
      chassis speed 0.5 and one float below (the reverse, brake-from-input
      and coasting edges);
    - ``unflip``: hovercars entering the unflip window (cos_theta < -0.9),
      just outside it, leaving it (> 0.2), lifting inside it, its timer
      running out, and an inactive one in it;
    - ``prop_waterline``: boats whose propeller is at the water level and
      one float above and below it, with and without thrust;
    - ``slow``: every type at chassis speeds of 0 up to 1e-3 (the drags'
      v_mag gate);
    - ``righting``: cars and bikes with the righting controller on, upright
      (the controller's zero-angle branch), tilted and on their roof;
    - ``v1`` and ``v33``: one car; 33 vehicles of the four types, some
      inactive (vehicles across a block boundary).

    Bodies, hits and inputs are random (seeded) where the case names none."""
    if case not in VEHICLE_CASES:
        raise ValueError(f"unknown vehicle case {case!r}")
    from substrata_tpu_torch.physics.vehicles import manager
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nv = {"v1": 1, "v33": 33}.get(case, 8)
    veh = {k: v.numpy().copy() for k, v in
           vars(manager.zero_vehicles(nv, device="cpu")).items()}
    vtypes = np.arange(nv) % 4
    if case in ("shift_edges", "righting", "wheels_2_4"):
        vtypes = np.arange(nv) % 2
    elif case == "unflip":
        vtypes = np.full(nv, 3)
    elif case == "prop_waterline":
        vtypes = np.full(nv, 2)
    elif case == "v1":
        vtypes = np.zeros(nv, np.int64)
    veh["vtype"][:] = vtypes
    veh["body_slot"][:] = np.arange(nv)
    veh["active"][:] = True
    for i, vt in enumerate(vtypes):
        if vt == 0:
            veh["wheel_attach"][i] = _CAR_WHEELS
            veh["n_wheels"][i] = 4
        elif vt == 1:
            veh["wheel_attach"][i, :2] = _BIKE_WHEELS
            veh["n_wheels"][i], veh["wheel_radius"][i] = 2, 0.3
            veh["engine_torque"][i], veh["engine_max_rpm"][i] = 390.0, 10000.0
        veh["propellor_os"][i] = (0.0, -2.0, -0.25)
        veh["areas"][i] = (1.5, 4.0, 8.0)
    veh["steering"][:] = rng.uniform(-0.3, 0.3, nv)
    veh["prev_sus_len"][:] = rng.uniform(0.1, 0.5, (nv, 4))
    veh["wheel_omega"][:] = rng.normal(0.0, 5.0, (nv, 4))
    veh["wheel_rot"][:] = rng.uniform(0.0, 6.0, (nv, 4))
    veh["gear"][:] = rng.integers(0, 5, nv)
    veh["shift_timer"][:] = np.where(rng.random(nv) < 0.5, 0.0, rng.uniform(0.0, 0.4, nv))
    if nv > 4:
        veh["y_fwd_quat"][4] = _quat_axis((0, 0, 1), np.pi / 2)
    inp = dict(forward=rng.uniform(-1, 1, nv).astype(f32),
               right=rng.uniform(-1, 1, nv).astype(f32), up=rng.uniform(0, 1, nv).astype(f32),
               brake=rng.random(nv) < 0.2, handbrake=rng.random(nv) < 0.2)
    pos = np.stack([np.arange(nv) * 5.0 - 20.0, np.full(nv, 18.0), np.full(nv, 0.8)],
                   axis=1).astype(f32)
    tilt = rng.normal(0.0, 0.15, (nv, 3))
    quat = np.concatenate([tilt * 0.5, np.ones((nv, 1))], axis=1)
    quat = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).astype(f32)
    lin = rng.normal(0.0, 3.0, (nv, 3)).astype(f32)
    ang = rng.normal(0.0, 0.5, (nv, 3)).astype(f32)
    mass = rng.uniform(200.0, 1500.0, nv).astype(f32)
    off = rng.normal(0.0, 0.02, (nv, 3, 3))
    iw = (np.eye(3)[None] * rng.uniform(0.5, 2.0, (nv, 1, 1)) + off + off.transpose(0, 2, 1))
    iw = (iw / mass[:, None, None]).astype(f32)
    ray_len = veh["sus_max"] + veh["wheel_radius"]
    hit_t = rng.uniform(0.3, 0.95, (nv, 4)).astype(f32)
    hn = rng.normal(0.0, 0.1, (nv, 4, 3)) + np.array([0.0, 0.0, 1.0])
    hit_n = (hn / np.linalg.norm(hn, axis=2, keepdims=True)).astype(f32)
    hit_ok = rng.random((nv, 4)) < 0.85
    up = _quat_axis((1, 0, 0), 0.0)

    if case == "types":
        veh["active"][nv // 2:] = False
    elif case == "airborne":
        hit_ok[:] = False
        hit_t[:] = ray_len[:, None]
    elif case == "wheels_2_4":
        for i in range(nv):
            veh["n_wheels"][i] = 2 if (i // 2) % 2 == 0 else 4
            veh["wheel_attach"][i] = _CAR_WHEELS
            if vtypes[i] == 1:
                veh["wheel_attach"][i, :2] = _BIKE_WHEELS
    elif case == "shift_edges":
        quat[:] = up
        lin[:] = 0.0
        ang[:] = 0.0
        inp["forward"][:] = 0.6
        veh["shift_timer"][:] = 0.0
        # The smallest normal float: a subnormal would read as 0 where the
        # reference's compiler flushes subnormals.
        veh["shift_timer"][[2, 5]] = np.finfo(f32).tiny
        for i in range(nv):
            bike = vtypes[i] == 1
            gears = manager.BIKE_GEAR_RATIOS if bike else manager.GEAR_RATIOS
            g = 1 + (i // 2) % 2
            veh["gear"][i] = g
            target = (manager.BIKE_SHIFT_UP_RPM if bike else manager.SHIFT_UP_RPM) \
                if i < 4 else (manager.BIKE_SHIFT_DOWN_RPM if bike else manager.SHIFT_DOWN_RPM)
            lo, hi = _rpm_speeds(gears[g], veh["wheel_radius"][i], target)
            lin[i, 1] = lo if (i % 4) < 2 else hi
    elif case == "input_edges":
        quat[:] = up
        lin[:] = 0.0
        ang[:] = 0.0
        m01 = f32(-0.01)
        fwd = [m01, np.nextafter(m01, f32(-1)), -m01, np.nextafter(-m01, f32(1)),
               np.nextafter(-m01, f32(0)), m01, np.nextafter(m01, f32(-1)), f32(0.0)]
        half = f32(0.5)
        speed = [half, half, half, half, half, np.nextafter(half, f32(0)),
                 np.nextafter(half, f32(0)), half]
        inp["forward"][:] = fwd
        inp["brake"][:] = False
        lin[:, 1] = speed
        veh["shift_timer"][:] = 0.0
    elif case == "unflip":
        cos_t = [-0.95, -0.85, 0.3, 0.1, 0.1, -0.95, 0.25, 0.15]
        unflip = [0.0, 0.0, 0.5, 0.5, 0.01, 0.0, 0.5, 0.5]
        for i in range(nv):
            quat[i] = _quat_axis((1, 0.2 * i, 0), np.arccos(cos_t[i]))
        veh["unflip_time"][:] = unflip
        veh["active"][7] = False
    elif case == "prop_waterline":
        quat[:] = up
        z = f32(VEHICLE_WATER_Z) - f32(-0.25)
        zs = [z, np.nextafter(z, f32(1)), np.nextafter(z, f32(0))]
        pos[:, 2] = [zs[i % 3] for i in range(nv)]
        inp["forward"][:] = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, -0.5, 0.5]
        lin[:, 2] = 0.0
    elif case == "slow":
        lin[:] = [[0, 0, 0], [0, 5e-4, 0], [1e-3, 0, 0], [0, 0, 1e-3],
                  [3e-4, 3e-4, 3e-4], [0, 1e-3 * 1.0001, 0], [-6e-4, 0, 6e-4], [0, 0, 0]]
        ang[:] = 0.0
        pos[:, 2] = 0.3
    elif case == "righting":
        veh["righting_active"][:] = True
        veh["righting_active"][7] = False
        angles = [0.0, 0.0, 0.6, 1.2, np.pi, np.pi - 0.1, 2.0, 0.8]
        for i in range(nv):
            quat[i] = _quat_axis((0.3 * i, 1.0, 0.1), angles[i])
        quat[0] = quat[1] = up
        ang[[0, 1]] = 0.0
    elif case == "v33":
        veh["active"][rng.random(nv) < 0.25] = False
        veh["righting_active"][rng.random(nv) < 0.3] = True
        veh["unflip_time"][vtypes == 3] = rng.choice([0.0, 0.5], int((vtypes == 3).sum()))
    return VehicleScene(veh=veh, inp=inp, chassis=(pos, quat, lin, ang, mass, iw),
                        hits=(hit_t, hit_n, hit_ok), water_z=VEHICLE_WATER_Z,
                        dt=1.0 / 60.0)


def vehicle_inputs(scene: VehicleScene, device):
    """``vehicle_forces``' arguments for ``scene`` on ``device``: (veh,
    inp, body_pos, body_quat, body_lin, body_ang, mass, iw, hit_t, hit_n,
    hit_ok, water_z, dt)."""
    from substrata_tpu_torch import convert
    veh = convert.vehicles_from_numpy(scene.veh, device=device)
    inp = convert.vehicle_inputs_from_numpy(scene.inp, device=device)
    rows = [torch.as_tensor(np.ascontiguousarray(x), device=device)
            for x in scene.chassis + scene.hits]
    water = torch.tensor(np.float32(scene.water_z), device=device)
    return (veh, inp, *rows, water, scene.dt)


# ---------------------------------------------------------------------------
# KT: incidence scenes.
# ---------------------------------------------------------------------------

INCIDENCE_CASES = ("none_occupied", "all_static", "list_64", "list_65", "one_body_everywhere",
                   "self_pair", "cpb1", "cpb16", "ragged_n", "blocked_st4", "key_bits")


@dataclasses.dataclass
class IncidenceScene:
    """KT's incidence inputs (numpy): the entries' a and b as rows of
    ``st`` (an entry's first row read; ``st`` > 1 is the pair-blocked
    layout, wm rows a pair), the occupancy, the body count and cpb."""
    rows_a: np.ndarray
    rows_b: np.ndarray
    occ: np.ndarray
    n: int
    cpb: int
    st: int


def incidence_scene(case: str, seed: int = 0) -> IncidenceScene:
    """The inputs of one hard incidence case, N = 512 bodies, C = 4,096
    entries, cpb 8, stride 1 and 90% of the entries occupied unless named:

    - ``none_occupied``: no entry occupied;
    - ``all_static``: every b static (-1);
    - ``list_64`` and ``list_65``: body 5 in exactly 64 and in 65 keys (its
      list full; one past it, the ordered walk), as a and as b;
    - ``one_body_everywhere``: body 3 is the a of every entry (N = 64, C =
      512), every entry occupied;
    - ``self_pair``: bodies that are both a and b of one entry;
    - ``cpb1`` and ``cpb16``: cpb 1 and 16 over crowded bodies (N = 256);
    - ``ragged_n``: N = 1,013 and C = 3,001;
    - ``blocked_st4``: a pair-blocked layout of stride 4 (N = 300), body 7
      in 100 entries;
    - ``key_bits``: N = 65,535 and C = 32,767, the largest packed key
      (16 + 15 + 1 = 32 bits)."""
    if case not in INCIDENCE_CASES:
        raise ValueError(f"unknown incidence case {case!r}")
    rng = np.random.default_rng(seed)
    n, c, cpb, st = 512, 4096, 8, 1
    if case == "one_body_everywhere":
        n, c = 64, 512
    elif case in ("cpb1", "cpb16"):
        n, cpb = 256, int(case[3:])
    elif case == "ragged_n":
        n, c = 1013, 3001
    elif case == "blocked_st4":
        n, st = 300, 4
    elif case == "key_bits":
        n, c = 65_535, 32_767
    a = rng.integers(0, n, c).astype(np.int32)
    b = rng.integers(-1, n, c).astype(np.int32)
    occ = rng.random(c) < 0.9
    if case == "none_occupied":
        occ[:] = False
    elif case == "all_static":
        b[:] = -1
    elif case in ("list_64", "list_65"):
        a[a == 5] = 6
        b[b == 5] = 6
        k = int(case[5:])
        idx = rng.choice(c, k, replace=False)
        occ[idx] = True
        a[idx[:40]] = 5
        b[idx[40:]] = 5
        a[idx[40:]] = np.where(a[idx[40:]] == 5, 6, a[idx[40:]])
    elif case == "one_body_everywhere":
        a[:] = 3
        b[b == 3] = -1
        occ[:] = True
    elif case == "self_pair":
        idx = rng.choice(c, 40, replace=False)
        b[idx] = a[idx]
        occ[idx[:30]] = True
    elif case == "blocked_st4":
        a[rng.choice(c, 100, replace=False)] = 7
        b[rng.choice(c, 20, replace=False)] = 9
    occ &= a >= 0
    rows_a = np.repeat(a, st)
    rows_b = np.repeat(b, st)
    if st > 1:
        # The rows past an entry's first are other contact rows: not read.
        rows_a[np.arange(rows_a.size) % st != 0] = -2
        rows_b[np.arange(rows_b.size) % st != 0] = -2
    return IncidenceScene(rows_a=rows_a, rows_b=rows_b, occ=occ, n=n, cpb=cpb, st=st)


def incidence_inputs(scene: IncidenceScene, device):
    """``layout.incidence``'s arguments for ``scene`` on ``device``:
    (entry_a, entry_b, entry_occ, n_bodies, cpb), a and b strided views
    when ``st`` > 1."""
    st = scene.st
    ta = torch.as_tensor(scene.rows_a, device=device).reshape(-1, st)[:, 0]
    tb = torch.as_tensor(scene.rows_b, device=device).reshape(-1, st)[:, 0]
    return ta, tb, torch.as_tensor(scene.occ, device=device), scene.n, scene.cpb


# ---------------------------------------------------------------------------
# KK: closed-form scenes.
# ---------------------------------------------------------------------------

CLOSED_FORM_CASES = ("every_code", "all_empty", "first_last", "warp_copies", "warp_distinct",
                     "distinct_4", "distinct_5", "parallel_face", "sensors", "blocked_wm1",
                     "blocked_wm2", "blocked_wm4", "single_combo", "ragged", "grouped_mixed",
                     "grouped_blocked")
_CF_CODES = (0, 1, 2, 4, 6, 8, 9, 10)
_CF_WIDTH = {0: 1, 1: 1, 2: 1, 4: 1, 6: 2, 8: 1, 9: 2, 10: 1}   # narrowphase._MANIFOLD_WIDTH


@dataclasses.dataclass
class ClosedFormScene:
    """KK's inputs (numpy): the bodies (BodyState fields) and either
    ``buckets`` [(code, ba, bb, bvalid)] with their widths ``wm`` and the
    layout (``blocked``), or a pair list ``pairs`` (pair_a, pair_b,
    pair_valid) with the SimConfig's keyword arguments ``cfg`` and
    ``blocked_wm``, grouped as ``narrowphase.pair_contacts`` groups it."""
    bodies: dict
    buckets: list | None = None
    wm: tuple | None = None
    blocked: bool = False
    pairs: tuple | None = None
    cfg: dict | None = None
    blocked_wm: int = 0


def _cf_shape(rng, st, n):
    prm = np.zeros((n, 4), np.float32)
    if st == 0:
        prm[:, 0] = rng.uniform(0.2, 0.6, n)
    elif st == 1:
        prm[:, :3] = rng.uniform(0.2, 0.7, (n, 3))
    else:
        prm[:, 0] = rng.uniform(0.15, 0.4, n)
        prm[:, 1] = rng.uniform(0.2, 0.6, n)
    return prm


def _cf_side(rng, st, n, spread=0.6):
    """``n`` bodies of shape type ``st`` at random poses within ``spread``
    of the origin: (pos, quat, type, params)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (rng.uniform(-spread, spread, (n, 3)).astype(np.float32), q.astype(np.float32),
            np.full(n, st, np.int32), _cf_shape(rng, st, n))


def _cf_bodies(rng, sides, sensor_frac=0.0):
    """BodyState fields (numpy) of the bodies in ``sides`` (a list of
    (pos, quat, type, params)), in that order: dynamic, alive, random
    materials; ``sensor_frac`` of them sensors."""
    from substrata_tpu_torch.physics import state
    pos, quat, st, prm = (np.concatenate(x) for x in zip(*sides))
    n = pos.shape[0]
    a = {k: v.numpy().copy() for k, v in vars(state.zero_body_state(n, device="cpu")).items()}
    a["pos"][:], a["quat"][:], a["shape_type"][:], a["shape_params"][:] = pos, quat, st, prm
    a["bound_radius"][:] = [_shape_bound(t, p) for t, p in zip(st, prm)]
    a["friction"][:] = rng.uniform(0.0, 1.0, n)
    a["restitution"][:] = rng.uniform(0.0, 1.0, n)
    a["is_sensor"][:] = rng.random(n) < sensor_frac
    a["alive"][:] = True
    a["awake"][:] = True
    a["motion_type"][:] = 2
    a["layer"][:] = 1
    return {k: np.ascontiguousarray(v) for k, v in a.items()}


def _cf_random_buckets(rng, spec, occupied=0.9, sensor_frac=0.05):
    """Bodies and buckets of distinct random pairs: ``spec`` [(code,
    slots)], side a's bodies then side b's for each bucket."""
    sides, buckets, base = [], [], 0
    for code, n in spec:
        sides += [_cf_side(rng, code // 4, n), _cf_side(rng, code % 4, n)]
        ba = np.arange(base, base + n, dtype=np.int32)
        buckets.append((code, ba, ba + n, rng.random(n) < occupied))
        base += 2 * n
    return _cf_bodies(rng, sides, sensor_frac), buckets


def _warp_pairs(rng, slots, distinct, n_pairs):
    """A bucket's (pair index) [slots] in which each warp of 32 slots holds
    ``distinct`` of the ``n_pairs`` pairs, on lanes in shuffled order."""
    idx = np.empty(slots, np.int64)
    for w in range(0, slots, 32):
        lanes = min(32, slots - w)
        pick = rng.choice(n_pairs, distinct, replace=False)
        row = np.concatenate([pick, rng.choice(pick, lanes - distinct)]) if lanes > distinct \
            else pick[:lanes]
        idx[w:w + lanes] = rng.permutation(row)
    return idx


def _parallel_face_sides(rng, n, code):
    """Capsules lying along x over a box's top face (a box of identity
    pose, the capsule's axis rotated from z to x), a little above, at or
    a little into the face: the distance is flat along the segment, so
    the search's comparisons are decided by rounding.  Box side first for
    code 6, capsule side first for code 9."""
    he = np.stack([rng.uniform(0.6, 1.2, n), rng.uniform(0.3, 0.6, n),
                   rng.uniform(0.2, 0.5, n)], axis=1).astype(np.float32)
    box_prm = np.zeros((n, 4), np.float32)
    box_prm[:, :3] = he
    cap_prm = np.zeros((n, 4), np.float32)
    cap_prm[:, 0] = rng.uniform(0.15, 0.3, n)
    cap_prm[:, 1] = rng.uniform(0.1, 0.5, n)
    s = np.float32(np.sqrt(0.5))
    cap_q = np.tile(np.array([0.0, s, 0.0, s], np.float32), (n, 1))
    box_q = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (n, 1))
    gap = rng.choice(np.array([-0.01, 0.0, 0.004, 0.02], np.float32), n)
    cap_pos = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.2, 0.2, n),
                        he[:, 2] + cap_prm[:, 0] + gap], axis=1).astype(np.float32)
    box_pos = np.zeros((n, 3), np.float32)
    box = (box_pos, box_q, np.full(n, 1, np.int32), box_prm)
    cap = (cap_pos, cap_q, np.full(n, 2, np.int32), cap_prm)
    return [box, cap] if code == 6 else [cap, box]


def closed_form_scene(case: str, seed: int = 0) -> ClosedFormScene:
    """The inputs of one hard closed-form case.  Pairs are drawn within
    touching range (about half in contact), 90% of the slots occupied and
    5% of the bodies sensors unless named; the compacted layout (each
    code's own width) unless named:

    - ``every_code``: one bucket of 200 slots for each closed-form code;
    - ``all_empty``: codes 6, 9 and 10 (256, 256 and 1,024 slots), no slot
      occupied, every slot holding the bodies of one pair (as KT's grouping
      pads a bucket);
    - ``first_last``: codes 1, 6, 9 and 10, 300 slots each, only the first
      and the last slot occupied, the others holding the first's pair;
    - ``warp_copies``: code 9, 160 slots: the first warp 32 copies of one
      pair, the second 32 copies of another with half of them occupied,
      the rest distinct;
    - ``warp_distinct``: code 6, 256 distinct pairs;
    - ``distinct_4``, ``distinct_5``: codes 6 and 9, 256 slots, each warp
      exactly 4 (5) distinct pairs on shuffled lanes;
    - ``parallel_face``: codes 6 and 9, capsules parallel to a box's top
      face, 256 distinct pairs then 64 slots of one warp's 3 pairs;
    - ``sensors``: codes 1, 6 and 9, a sensor on side a, on side b, on
      both and on neither;
    - ``blocked_wm1``, ``blocked_wm2``, ``blocked_wm4``: every code, 96
      slots each, the pair-blocked layout at width 1, 2 and 4 (empty slots
      a = -1);
    - ``single_combo``: a capsule world through ``pair_contacts`` (one
      combo: the pair list in place), the invalid entries holding stale
      ids and -1;
    - ``ragged``: codes 0, 2, 4, 6, 8 and 9 at 1, 31, 33, 127, 129 and
      1,000 slots;
    - ``grouped_mixed``, ``grouped_blocked``: a pile of spheres, boxes and
      capsules through ``pair_contacts``'s grouping, compacted and at
      blocked width 4.
    """
    if case not in CLOSED_FORM_CASES:
        raise ValueError(f"unknown closed-form case {case!r}")
    rng = np.random.default_rng(seed)
    if case in ("single_combo", "grouped_mixed", "grouped_blocked"):
        return _cf_pair_scene(rng, case)
    wm_all, blocked = None, False
    if case == "every_code":
        bodies, buckets = _cf_random_buckets(rng, [(c, 200) for c in _CF_CODES])
    elif case == "all_empty":
        sides = [_cf_side(rng, 1, 1), _cf_side(rng, 2, 1)]
        bodies = _cf_bodies(rng, sides)
        buckets = [(c, np.zeros(n, np.int32), np.ones(n, np.int32), np.zeros(n, bool))
                   for c, n in ((6, 256), (9, 256), (10, 1024))]
    elif case == "first_last":
        bodies, buckets = _cf_random_buckets(rng, [(c, 300) for c in (1, 6, 9, 10)])
        for _, ba, bb, bv in buckets:
            ba[1:-1], bb[1:-1] = ba[0], bb[0]
            bv[:] = False
            bv[0] = bv[-1] = True
    elif case in ("warp_copies", "warp_distinct", "distinct_4", "distinct_5"):
        codes = {"warp_copies": (9,), "warp_distinct": (6,)}.get(case, (6, 9))
        slots = 160 if case == "warp_copies" else 256
        bodies, buckets = _cf_random_buckets(rng, [(c, slots) for c in codes])
        for _, ba, bb, bv in buckets:
            if case == "warp_copies":
                idx = np.arange(slots)
                idx[:32], idx[32:64] = 5, 40
                bv[:32] = True
                bv[32:64] = np.arange(32) % 2 == 0
            elif case.startswith("distinct"):
                idx = _warp_pairs(rng, slots, int(case[-1]), slots)
            else:
                continue
            ba[:], bb[:] = ba[idx], bb[idx]
    elif case == "parallel_face":
        sides, buckets, base = [], [], 0
        for code in (6, 9):
            n = 256
            sides += _parallel_face_sides(rng, n, code)
            idx = np.concatenate([np.arange(n), rng.choice(3, 64)])
            ba = (base + idx).astype(np.int32)
            buckets.append((code, ba, ba + n, rng.random(n + 64) < 0.9))
            base += 2 * n
        bodies = _cf_bodies(rng, sides)
    elif case == "sensors":
        bodies, buckets = _cf_random_buckets(rng, [(c, 128) for c in (1, 6, 9)], sensor_frac=0)
        for _, ba, bb, _ in buckets:
            kind = np.arange(ba.shape[0]) % 4
            bodies["is_sensor"][ba[kind == 1]] = True
            bodies["is_sensor"][bb[kind == 2]] = True
            bodies["is_sensor"][ba[kind == 3]] = True
            bodies["is_sensor"][bb[kind == 3]] = True
    elif case.startswith("blocked_wm"):
        bodies, buckets = _cf_random_buckets(rng, [(c, 96) for c in _CF_CODES], occupied=0.7)
        wm_all, blocked = int(case[-1]), True
    elif case == "ragged":
        bodies, buckets = _cf_random_buckets(
            rng, list(zip((0, 2, 4, 6, 8, 9), (1, 31, 33, 127, 129, 1000))))
    wm = tuple(wm_all or _CF_WIDTH[c] for c, *_ in buckets)
    return ClosedFormScene(bodies=bodies, buckets=buckets, wm=wm, blocked=blocked)


def _cf_pair_scene(rng, case):
    """The ``pair_contacts`` scenes: a pile of 96 bodies on a jittered
    lattice, 0.8 m apart (capsules only for ``single_combo``), and every
    pair within 1.2 m, shuffled; ``single_combo`` adds invalid entries with
    stale ids and -1."""
    n = 96
    types = (2,) if case == "single_combo" else (0, 1, 2)
    k = np.arange(n)
    pos = np.stack([k % 6 * 0.8, k // 6 % 4 * 0.8, 0.5 + k // 24 * 0.8], axis=1)
    pos = (pos + rng.uniform(-0.15, 0.15, (n, 3))).astype(np.float32)
    sides = []
    for i in range(n):
        st = int(rng.choice(types))
        side = _cf_side(rng, st, 1)
        sides.append((pos[i:i + 1], side[1], side[2], side[3] * np.float32(0.8)))
    bodies = _cf_bodies(rng, sides, sensor_frac=0.05)
    ia, ib = np.triu_indices(n, 1)
    near = np.linalg.norm(pos[ia] - pos[ib], axis=1) < 1.2
    order = rng.permutation(int(near.sum()))
    pa, pb = ia[near][order].astype(np.int32), ib[near][order].astype(np.int32)
    swap = rng.random(pa.shape[0]) < 0.5
    pa, pb = np.where(swap, pb, pa), np.where(swap, pa, pb)
    pv = np.ones(pa.shape[0], bool)
    if case == "single_combo":
        m = 40
        stale_a = rng.integers(-1, n, m).astype(np.int32)
        stale_b = rng.integers(-1, n, m).astype(np.int32)
        at = np.sort(rng.choice(pa.shape[0] + m, m, replace=False))
        keep = np.setdiff1d(np.arange(pa.shape[0] + m), at)
        a2 = np.empty(pa.shape[0] + m, np.int32)
        b2 = np.empty_like(a2)
        v2 = np.zeros(a2.shape[0], bool)
        a2[keep], b2[keep], v2[keep] = pa, pb, True
        a2[at], b2[at] = stale_a, stale_b
        pa, pb, pv = a2, b2, v2
        present = (False, False, True, False)
    else:
        present = (True, True, True, False)
    p = 512 if case != "single_combo" else pa.shape[0]
    if pa.shape[0] < p:
        pad = p - pa.shape[0]
        pa = np.concatenate([pa, np.full(pad, -1, np.int32)])
        pb = np.concatenate([pb, np.full(pad, -1, np.int32)])
        pv = np.concatenate([pv, np.zeros(pad, bool)])
    cfg = dict(capacity=n, max_pairs=p, grid_dim=16, cell_size=2.0, pairs_per_body=8,
               present_shape_types=present)
    return ClosedFormScene(bodies=bodies, pairs=(pa, pb, pv), cfg=cfg,
                           blocked_wm=4 if case == "grouped_blocked" else 0)


def closed_form_inputs(scene: ClosedFormScene, device):
    """``closed_forms.closed_form_buckets``'s arguments for ``scene`` on
    ``device``: (buckets [(code, ba, bb, bvalid)], wm, blocked, pos, quat,
    shape_params, friction, restitution, is_sensor).  A scene's own buckets
    are views of one array each for ba, bb and bvalid, in bucket order (as
    KT's grouping lays them out); a pair scene's are ``narrowphase.
    buckets``' closed-form buckets on ``device``."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.physics import narrowphase
    from substrata_tpu_torch.physics.state import SimConfig
    body = convert.body_state_from_numpy(scene.bodies, device=device)
    rows = (body.pos, body.quat, body.shape_params, body.friction, body.restitution,
            body.is_sensor)
    if scene.pairs is not None:
        cfg = SimConfig(**scene.cfg)
        pa, pb, pv = (torch.as_tensor(x, device=device) for x in scene.pairs)
        groups = narrowphase.buckets(body, pa, pb, pv, cfg)[0]
        buckets = [(c, ba, bb, bv) for c, _, ba, bb, bv in groups if c in _CF_CODES]
        wm = tuple(scene.blocked_wm or _CF_WIDTH[c] for c, *_ in buckets)
        return (buckets, wm, bool(scene.blocked_wm)) + rows
    sizes = [b[1].shape[0] for b in scene.buckets]
    ba, bb, bv = (torch.as_tensor(np.concatenate([b[i] for b in scene.buckets]), device=device)
                  for i in (1, 2, 3))
    buckets = [(c, *(t.split(sizes)[k] for t in (ba, bb, bv)))
               for k, (c, *_) in enumerate(scene.buckets)]
    return (buckets, scene.wm, scene.blocked) + rows


def closed_form_pair_inputs(scene: ClosedFormScene, device):
    """``narrowphase.pair_contacts``'s arguments for a pair scene on
    ``device``: (BodyState, pair_a, pair_b, pair_valid, SimConfig) and
    ``blocked_wm`` as a keyword."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.physics.state import SimConfig
    pa, pb, pv = (torch.as_tensor(x, device=device) for x in scene.pairs)
    return ((convert.body_state_from_numpy(scene.bodies, device=device), pa, pb, pv,
             SimConfig(**scene.cfg)), dict(blocked_wm=scene.blocked_wm))


# ---------------------------------------------------------------------------
# KAA: audio setup scenes.
# ---------------------------------------------------------------------------

AUDIO_SETUP_CASES = ("s1", "s31", "s32", "s33", "s512", "s1024", "l1", "at_listener",
                     "behind_above", "azimuth_wrap", "inactive", "doppler_clamp", "occluded",
                     "mute_rate_0")
AUDIO_SETUP_BLOCK = 256     # the client's render block
AUDIO_SETUP_FIELDS = ("alive", "paused", "finished", "spatial", "pos", "vel", "delta",
                      "doppler_factor", "mute_factor", "mute_target", "mute_rate", "volume",
                      "num_occlusions")
LISTENER_AXES = ("pos", "vel", "right", "forward", "up")


@dataclasses.dataclass
class AudioSetupScene:
    """KAA's setup inputs (numpy): the source fields it reads
    (AUDIO_SETUP_FIELDS), the listener's axes (LISTENER_AXES) and the
    block's frame count."""
    sources: dict
    listener: dict
    block: int


def audio_setup_scene(case: str, seed: int = 0) -> AudioSetupScene:
    """``s{S}``: S sources (1, 31, 32, 33, 512, 1,024: one, either side of
    a warp, the client's 512 and past it) of every kind at random: 95%
    alive, 5% paused, 5% finished, 10% not spatial, 30% occluded once or
    twice, 3 layers, moving up to 20 m/s within 30 m of a listener turned
    0.4 rad and moving; 64 sources unless named:

    - ``l1``: one layer;
    - ``at_listener``: half the sources exactly at the listener (distance
      0: the direction and the bin from zeros);
    - ``behind_above``: sources behind the listener and straight above
      and below it (azimuth from two zeros, elevation at its clamps);
    - ``azimuth_wrap``: an axis-aligned listener, sources behind it with x
      = +-0, +-1e-3 and +-1e-30 (atan2 at +-pi: bin 8 from either side)
      and on each bin's centre;
    - ``inactive``: every source dead, paused or finished in turn;
    - ``doppler_clamp``: sources approaching and receding near and past
      the speed of sound (the factor clamped at 2 and 0.5, the divisor at
      1);
    - ``occluded``: every source occluded 1-3 times, then none;
    - ``mute_rate_0``: no fade moves (rate 0).
    """
    if case not in AUDIO_SETUP_CASES:
        raise ValueError(f"unknown audio setup case {case!r}")
    rng = np.random.default_rng(seed)
    s = int(case[1:]) if case[0] == "s" else 64
    nl = 1 if case == "l1" else 3
    f32 = np.float32
    src = dict(alive=rng.random(s) < 0.95, paused=rng.random(s) < 0.05,
               finished=rng.random(s) < 0.05, spatial=rng.random(s) < 0.9,
               pos=rng.uniform(-30, 30, (s, 3)), vel=rng.uniform(-20, 20, (s, 3)),
               delta=rng.uniform(0.5, 2.4, (s, nl)), doppler_factor=rng.uniform(0.6, 1.8, s),
               mute_factor=rng.uniform(0, 1, s), mute_target=rng.uniform(0, 1, s),
               mute_rate=rng.uniform(0, 10, s), volume=rng.uniform(0.5, 1.0, s),
               num_occlusions=(rng.random(s) < 0.3) * rng.integers(1, 3, s))
    ang = 0.4
    lis = dict(pos=np.array([0.5, -0.3, 0.2]), vel=np.array([2.0, -1.0, 0.5]),
               right=np.array([np.cos(ang), -np.sin(ang), 0.0]),
               forward=np.array([np.sin(ang), np.cos(ang), 0.0]), up=np.array([0.0, 0.0, 1.0]))
    half = np.arange(s) % 2 == 0
    if case == "at_listener":
        src["pos"][half] = lis["pos"]
    elif case in ("behind_above", "azimuth_wrap"):
        lis = dict(pos=np.zeros(3), vel=np.zeros(3), right=np.array([1.0, 0.0, 0.0]),
                   forward=np.array([0.0, 1.0, 0.0]), up=np.array([0.0, 0.0, 1.0]))
        if case == "behind_above":
            k = np.arange(s) % 4
            src["pos"][:, 1] = -np.abs(src["pos"][:, 1]) - 0.5
            src["pos"][k == 1, :2] = 0.0
            src["pos"][k == 2, :2] = 0.0
            src["pos"][k == 2, 2] = -np.abs(src["pos"][k == 2, 2])
        else:
            xs = np.array([0.0, -0.0, 1e-3, -1e-3, 1e-30, -1e-30])
            src["pos"][:, 0] = np.resize(xs, s)
            src["pos"][:, 1] = -rng.uniform(1, 30, s)
            centre = np.arange(s) >= s // 2
            az = (np.arange(s) % 16) * (2 * np.pi / 16) - np.pi
            r = rng.uniform(1, 30, s)
            src["pos"][centre, 0] = (r * np.sin(az))[centre]
            src["pos"][centre, 1] = (r * np.cos(az))[centre]
    elif case == "inactive":
        k = np.arange(s) % 4
        src["alive"][:], src["paused"][:], src["finished"][:] = k != 1, k == 2, k == 3
    elif case == "doppler_clamp":
        to = src["pos"] - lis["pos"]
        dirn = to / np.linalg.norm(to, axis=1, keepdims=True)
        speed = np.resize(np.array([-200.0, 400.0, -343.0, -343.5, -1000.0, 342.0]), s)
        src["vel"][:] = dirn * speed[:, None]
        src["spatial"][:] = True
    elif case == "occluded":
        src["num_occlusions"][:] = np.where(half, rng.integers(1, 4, s), 0)
    elif case == "mute_rate_0":
        src["mute_rate"][:] = 0.0
    src = {k: np.ascontiguousarray(v if v.dtype == bool else v.astype(f32))
           for k, v in src.items()}
    return AudioSetupScene(sources=src, listener={k: v.astype(f32) for k, v in lis.items()},
                           block=AUDIO_SETUP_BLOCK)


def audio_setup_inputs(scene: AudioSetupScene, device, use_hrtf: bool):
    """``audio_setup.audio_setup``'s arguments for ``scene`` on ``device``."""
    from substrata_tpu_torch.kernels import audio_setup as kaa
    src = [torch.as_tensor(scene.sources[k], device=device) for k in AUDIO_SETUP_FIELDS]
    lis = [torch.as_tensor(scene.listener[k], device=device) for k in LISTENER_AXES]
    return (*src, *lis, kaa.dop_alpha(scene.block), scene.block / kaa.ENGINE_RATE, use_hrtf)


# ---------------------------------------------------------------------------
# KF's folded epilogue (KAA's before): finished, level meter, alive.
# ---------------------------------------------------------------------------

EPILOGUE_CASES = ("head_at_end", "looping", "stream_mode", "inactive", "already_finished",
                  "remove_on_finish", "nan_level", "s1", "s31", "s33", "s1024", "l1")
EPILOGUE_BLOCK = 256        # the client's render block
EPILOGUE_FIELDS = ("finished", "looping", "stream_mode", "active", "new_heads", "buf_len",
                   "smoothed_level", "alive", "remove_on_finish")


@dataclasses.dataclass
class EpilogueScene:
    """KF's inputs (``spatialise``, as ``SpatialiseScene``'s arrays, HRTF
    on, B = 256, T = 64) and the epilogue's (``epilogue``, by
    ``EPILOGUE_FIELDS``; new_heads and buf_len [S, L])."""
    spatialise: dict
    epilogue: dict


def _epilogue_fields(rng, s, nl):
    """The epilogue's inputs for ``s`` sources of ``nl`` layers: 10%
    finished, 30% looping, 10% streaming, 80% active, 90% alive, half
    removed on finish, heads spread over [0, 1.1 buf_len)."""
    buf_len = rng.integers(1000, 50_000, (s, nl)).astype(np.int32)
    return dict(finished=rng.random(s) < 0.1, looping=rng.random(s) < 0.3,
                stream_mode=rng.random(s) < 0.1, active=rng.random(s) < 0.8,
                new_heads=(rng.uniform(0, 1.1, (s, nl)) * buf_len).astype(np.float32),
                buf_len=buf_len, smoothed_level=rng.uniform(0, 1, s).astype(np.float32),
                alive=rng.random(s) < 0.9, remove_on_finish=rng.random(s) < 0.5)


def epilogue_scene(case: str, seed: int = 0) -> EpilogueScene:
    """64 sources of 3 layers unless named (``s{S}``: 1, 31, 33, 1,024
    sources, either side of a warp and past the client's 512; ``l1``: one
    layer); 10% finished, 30% looping, 10% streaming, 80% active, 90%
    alive, half removed on finish, heads spread over [0, 1.1 buf_len):

    - ``head_at_end``: every source able to finish, half of the heads at
      exactly buf_len - 1 (finishes) and half one ulp below (does not);
    - ``looping``, ``stream_mode``, ``inactive``: every source so and
      none finished yet, every head past its end (none finishes);
    - ``already_finished``: every source finished, heads at 0;
    - ``remove_on_finish``: every source alive and able to finish, half
      past the end, half removed on finish (the four combinations);
    - ``nan_level``: a quarter of the gains NaN, so their levels and
      smoothed levels are NaN.
    """
    if case not in EPILOGUE_CASES:
        raise ValueError(f"unknown epilogue case {case!r}")
    rng = np.random.default_rng(seed)
    s = int(case[1:]) if case[0] == "s" and case[1:].isdigit() else 64
    nl = 1 if case == "l1" else 3
    b, t = EPILOGUE_BLOCK, 64
    f32 = np.float32
    x = rng.normal(0.0, 0.1, (s, b))
    loud = rng.random((s, b)) < 0.01
    samples = np.where(loud, rng.uniform(-1, 1, (s, b)), x).astype(f32)
    na, ne = SPATIALISE_BANK
    gain = rng.uniform(0, 1, s).astype(f32)
    if case == "nan_level":
        gain[np.arange(s) % 4 == 1] = np.nan
    spat = dict(
        samples=samples, lp_state=rng.normal(0.0, 0.1, s).astype(f32),
        alpha=rng.choice(np.array([0.1024, 0.3491, 1.0], f32), s),
        use_lp=rng.random(s) < 0.5, spatial=rng.random(s) < 0.75,
        hrir_hist=rng.normal(0.0, 0.1, (s, t - 1)).astype(f32),
        bank=rng.normal(0.0, 0.2, (na, ne, 2, t)).astype(f32),
        dir_idx=rng.integers(0, na * ne, s).astype(np.int32),
        prev_gl=rng.uniform(0, 1, s).astype(f32), prev_gr=rng.uniform(0, 1, s).astype(f32),
        gl=rng.uniform(0, 1, s).astype(f32), gr=rng.uniform(0, 1, s).astype(f32),
        ramp=np.linspace(0.0, 1.0, b, dtype=f32), gain=gain,
        send_gain=rng.uniform(0, 1, s).astype(f32))
    ep = _epilogue_fields(rng, s, nl)
    buf_len = ep["buf_len"]
    half = np.arange(s) % 2 == 0
    past = buf_len[:, 0].astype(f32) + f32(10.0)
    able = ("head_at_end", "remove_on_finish")
    if case in able:
        ep["finished"][:], ep["looping"][:], ep["stream_mode"][:] = False, False, False
        ep["active"][:] = True
    if case == "head_at_end":
        end = buf_len[:, 0].astype(f32) - f32(1.0)
        ep["new_heads"][:, 0] = np.where(half, end, np.nextafter(end, f32(-np.inf)))
    elif case in ("looping", "stream_mode", "inactive"):
        ep["new_heads"][:, 0] = past
        ep["finished"][:] = False
        if case == "inactive":
            ep["active"][:] = False
        else:
            ep[case][:] = True
    elif case == "already_finished":
        ep["finished"][:] = True
        ep["new_heads"][:] = 0.0
    elif case == "remove_on_finish":
        ep["alive"][:] = True
        ep["new_heads"][:, 0] = np.where(half, past, f32(0.0))
        ep["remove_on_finish"][:] = np.arange(s) % 4 < 2
    return EpilogueScene(spatialise=spat, epilogue=ep)


def epilogue_inputs(scene: EpilogueScene, device):
    """(``audio_spatialise``'s arguments, ``use_hrtf`` last; its
    ``epilogue=`` tuple) on ``device``."""
    a = scene.spatialise
    sargs = tuple(torch.as_tensor(a[k], device=device) for k in SPATIALISE_ARGS) + (True,)
    return sargs, tuple(torch.as_tensor(scene.epilogue[k], device=device)
                        for k in EPILOGUE_FIELDS)


# ---------------------------------------------------------------------------
# KA: box-box pair slots.
# ---------------------------------------------------------------------------

BOX_BOX_CASES = ("resting_stacks", "crossed_edges", "bias_ties", "margin_ties", "separated",
                 "invalid_sensor", "warp_repeat", "ragged", "full")
BOX_BOX_FULL = 16384     # the bench world's max_pairs


@dataclasses.dataclass
class BoxBoxScene:
    """Bodies (pos, quat, shape_params, friction, restitution, is_sensor)
    and the pair slots (pair_a, pair_b, pair_valid) of KA's call."""
    bodies: dict
    pair_a: np.ndarray
    pair_b: np.ndarray
    pair_valid: np.ndarray


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _axis_quats(axis, angle):
    angle = np.asarray(angle, np.float64)
    return np.concatenate([np.asarray(axis, np.float64) * np.sin(angle / 2)[..., None],
                           np.cos(angle / 2)[..., None]], -1)


def _box_pairs(rng, kind, m):
    """(pa, qa, hea, pb, qb, heb) float64 for m pairs of one kind."""
    he = rng.uniform(0.2, 0.6, (2, m, 3))
    pa = rng.uniform(-20, 20, (m, 3))
    qa = np.tile([0.0, 0.0, 0.0, 1.0], (m, 1))
    qb, pb = qa.copy(), pa.copy()
    if kind == "stack":       # exactly axis-aligned, b on a within +-5 cm
        pb[:, 2] += he[0, :, 2] + he[1, :, 2] + rng.uniform(-0.05, 0.05, m)
        pb[:, :2] += rng.uniform(-0.4, 0.4, (m, 2))
    elif kind == "crossed":   # a turned 45 degrees about x, b about y
        qa = _axis_quats([1, 0, 0], np.pi / 4 + rng.uniform(-0.05, 0.05, m))
        qb = _axis_quats([0, 1, 0], np.pi / 4 + rng.uniform(-0.05, 0.05, m))
        pb[:, 2] += (np.hypot(he[0, :, 1], he[0, :, 2]) + np.hypot(he[1, :, 0], he[1, :, 2])
                     + rng.uniform(-0.06, 0.03, m))
        pb[:, :2] += rng.uniform(-0.05, 0.05, (m, 2))
    else:                     # random turns at touching range, or apart
        qa, qb = _unit_quats(rng, m), _unit_quats(rng, m)
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        reach = np.linalg.norm(he[0], axis=1) + np.linalg.norm(he[1], axis=1)
        far = rng.uniform(1.05, 2.0, m) if kind == "separated" else rng.uniform(0.45, 0.9, m)
        pb += d * (reach * far)[:, None]
    return pa, qa, he[0], pb, qb, he[1]


def _nearest_ties(rng, kind, m, pool=8, steps=48):
    """m random pairs set at a decision's threshold: each of m * pool
    random pairs at touching range slides along its offset until the
    decision changes sign between two scales, then the scale is bisected
    (float64, ``steps`` halvings) down to float32 rounding.  ``bias``: the
    face/edge choice (best_edge against best_face * 0.98 + 0.001); ``margin``:
    the separation against the 4 cm margin."""
    pa, qa, hea, pb, qb, heb = _box_pairs(rng, "random", m * pool)
    off = pb - pa
    f32 = np.float32

    def decision(scale):
        t = [torch.as_tensor(np.asarray(x, f32))
             for x in (pa, qa, hea, pa + off * scale[:, None], qb, heb)]
        fa, fb, e = _seps(t)
        if kind == "bias":
            return (e - (torch.maximum(fa, fb) * 0.98 + 0.001)).double().numpy()
        return (torch.maximum(torch.maximum(fa, fb), e) - 0.04).double().numpy()
    lo, hi = np.full(len(pa), 0.3), np.full(len(pa), 1.6)
    f_lo, f_hi = decision(lo), decision(hi)
    keep = np.flatnonzero(np.sign(f_lo) != np.sign(f_hi))[:m]
    lo, hi, f_lo = lo[keep], hi[keep], f_lo[keep]
    pa, qa, hea, off, qb, heb = (x[keep] for x in (pa, qa, hea, off, qb, heb))
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        f_mid = decision(mid)
        left = np.sign(f_mid) == np.sign(f_lo)
        lo, f_lo = np.where(left, mid, lo), np.where(left, f_mid, f_lo)
        hi = np.where(left, hi, mid)
    return pa, qa, hea, pa + off * lo[:, None], qb, heb


def _seps(t):
    """(best_face_a, best_face_b, best_edge) of ``box_box.box_box``'s SAT,
    in its operations and order (written out here: the bench scripts run
    these scenes through a parent checkout's twin as well)."""
    from substrata_tpu_torch.kernels import box_box as ka
    from substrata_tpu_torch.maths import quat as quatm
    pa, qa, hea, pb, qb, heb = t
    ra, rb = quatm.to_matrix(qa), quatm.to_matrix(qb)
    c = (ra[..., 0, :, None] * rb[..., 0, None, :] + ra[..., 1, :, None] * rb[..., 1, None, :]
         + ra[..., 2, :, None] * rb[..., 2, None, :])
    absc = torch.abs(c) + 1e-5
    tt = ka._mtv(ra, pb - pa)
    sep_a = torch.abs(tt) - (hea + ka._mv(absc, heb))
    sep_b = torch.abs(ka._mtv(c, tt)) - (heb + ka._mtv(absc, hea))
    seps = []
    for i in range(3):
        for j in range(3):
            i1, i2, j1, j2 = (i + 1) % 3, (i + 2) % 3, (j + 1) % 3, (j + 2) % 3
            zero = torch.zeros_like(tt[..., 0])
            comps = [zero, zero, zero]
            comps[i1], comps[i2] = -c[..., i2, j], c[..., i1, j]
            axis = torch.stack(comps, -1)
            alen = ka._norm3(axis)
            den = torch.clamp(alen, min=1e-9)
            d = (torch.abs(quatm.dot3(tt, axis / den[..., None]))
                 - (hea[..., i1] * absc[..., i2, j] + hea[..., i2] * absc[..., i1, j]
                    + (heb[..., j1] * absc[..., i, j2] + heb[..., j2] * absc[..., i, j1]))
                 / den)
            seps.append(torch.where(alen > 1e-6, d, -1e9))
    return sep_a.max(-1).values, sep_b.max(-1).values, torch.stack(seps, -1).max(-1).values


def box_box_scene(case: str, seed: int = 0) -> BoxBoxScene:
    """KA's inputs for one case; bodies 2i and 2i + 1 make pair i unless
    the case says otherwise:

    - ``resting_stacks``: axis-aligned boxes on boxes (the rotation
      products' exact zeros, the edge axes of zero length);
    - ``crossed_edges``: boxes turned 45 degrees about x and y, edge on edge;
    - ``bias_ties``, ``margin_ties``: random pairs slid along their offset
      until their face/edge choice (the 0.98 bias) or separation (the 4 cm
      margin) sits at its threshold, to float32 rounding;
    - ``separated``: pairs apart by 5-100% of their reach;
    - ``invalid_sensor``: a third of the slots invalid (a = -1 and stale
      ids), a tenth of the bodies sensors;
    - ``warp_repeat``: one touching pair in all 64 slots;
    - ``ragged``: 1,001 slots (not a multiple of 4 or 32), the last 37
      empty;
    - ``full``: all 16,384 slots of the bench world's max_pairs, every kind
      mixed.
    """
    if case not in BOX_BOX_CASES:
        raise ValueError(f"unknown box-box case {case!r}")
    rng = np.random.default_rng(seed + 100 + BOX_BOX_CASES.index(case))
    kinds = {"resting_stacks": ("stack",), "crossed_edges": ("crossed",),
             "separated": ("separated",), "invalid_sensor": ("stack", "random", "crossed"),
             "warp_repeat": ("random",), "ragged": ("stack", "random", "crossed", "separated"),
             "full": ("stack", "random", "crossed", "separated")}
    m = {"full": BOX_BOX_FULL, "ragged": 1001 - 37, "warp_repeat": 1}.get(case, 256)
    if case in ("bias_ties", "margin_ties"):
        parts = [_nearest_ties(rng, case[:-5] if case == "bias_ties" else "margin", m)]
    else:
        ks = kinds[case]
        sizes = [m // len(ks) + (i < m % len(ks)) for i in range(len(ks))]
        parts = [_box_pairs(rng, k, s) for k, s in zip(ks, sizes)]
    pa, qa, hea, pb, qb, heb = (np.concatenate(x) for x in zip(*parts))
    if case == "warp_repeat":      # nudge the one pair into contact
        qa, qb = _axis_quats([1, 0, 0], [0.3]), _axis_quats([0, 1, 0], [0.2])
        pb = pa + np.array([[0.1, 0.05, 0.0]])
        pb[:, 2] += hea[:, 2] + heb[:, 2] - 0.02
    m = pa.shape[0]
    n = 2 * m
    f32 = np.float32
    bodies = dict(pos=np.empty((n, 3), f32), quat=np.empty((n, 4), f32),
                  shape_params=np.zeros((n, 4), f32),
                  friction=rng.uniform(0.0, 1.0, n).astype(f32),
                  restitution=rng.uniform(0.0, 1.0, n).astype(f32),
                  is_sensor=rng.random(n) < {"invalid_sensor": 0.1, "warp_repeat": 0.0}.get(
                      case, 0.02))
    bodies["pos"][0::2], bodies["pos"][1::2] = pa, pb
    bodies["quat"][0::2], bodies["quat"][1::2] = qa, qb
    bodies["shape_params"][0::2, :3], bodies["shape_params"][1::2, :3] = hea, heb
    slots = {"warp_repeat": 64, "ragged": 1001}.get(case, m)
    pair_a = np.full(slots, -1, np.int32)
    pair_b = np.full(slots, -1, np.int32)
    if case == "warp_repeat":
        pair_a[:], pair_b[:] = 0, 1
    else:
        pair_a[:m], pair_b[:m] = np.arange(0, n, 2), np.arange(1, n, 2)
    pair_valid = pair_a >= 0
    if case == "invalid_sensor":
        off = rng.random(slots) < 1 / 3
        pair_valid &= ~off
        pair_a[off & (rng.random(slots) < 0.5)] = -1      # the rest keep stale ids
    return BoxBoxScene({k: np.ascontiguousarray(v) for k, v in bodies.items()},
                       pair_a, pair_b, pair_valid)


def box_box_inputs(scene: BoxBoxScene, device):
    """``box_box.box_box_rows``' arguments for ``scene`` on ``device``."""
    b = scene.bodies
    return tuple(torch.as_tensor(x, device=device) for x in (
        b["pos"], b["quat"], b["shape_params"], b["friction"], b["restitution"],
        b["is_sensor"], scene.pair_a, scene.pair_b, scene.pair_valid))


# ---------------------------------------------------------------------------
# KU: position-solve scenes.
# ---------------------------------------------------------------------------

POSITION_CASES = ("cpb_limit", "asleep", "invalid_rows", "padded_entries", "static_only",
                  "pairs_only", "wm1", "wm4", "k8", "iters1", "iters3", "cpb40")
POSITION_N, POSITION_Q = 64, 96


@dataclasses.dataclass
class PositionScene:
    """KU's inputs: positions, inverse masses and awake flags [N]; the
    static rows (valid, normal, penetration) [N K]; the pair rows (a, b,
    valid, normal, penetration) [Q wm]; the entries' occupancy for the
    incidence table; the call's shapes, iterations, beta and slop."""
    pos: np.ndarray
    inv_mass: np.ndarray
    awake: np.ndarray
    static: dict
    pair: dict
    occupied: np.ndarray
    k: int
    wm: int
    cpb: int
    iters: int
    beta: float
    slop: float


def position_scene(case: str, seed: int = 0) -> PositionScene:
    """64 bodies (48 alive and dynamic), 96 entries; K = 4 static rows a
    body, wm = 2 rows an entry, CPB = 8 table slots, 2 iterations unless
    the case says otherwise; penetrations from -2 to 8 cm about a 1 cm
    slop:

    - ``cpb_limit``: one body in 9 entries (one past CPB), another in 8;
    - ``asleep``: every other body asleep (immovable);
    - ``invalid_rows``: static rows 1 and 2 and every entry's row 1
      invalid;
    - ``padded_entries``: an eighth of the entries with a = -1 (not in the
      table), another eighth with b = -1 (body 0's mass read, as the
      reference gathers it);
    - ``static_only``: every entry padded (an empty table);
    - ``pairs_only``: no valid static row;
    - ``wm1``, ``wm4``: manifold widths 1 (the compacted layout: invalid
      rows are not tabled) and 4;
    - ``k8``: K = 8;
    - ``iters1``, ``iters3``: one and three iterations;
    - ``cpb40``: CPB = 40, one body in all 40 (lanes take two rounds).
    """
    if case not in POSITION_CASES:
        raise ValueError(f"unknown position case {case!r}")
    rng = np.random.default_rng(seed + 300 + POSITION_CASES.index(case))
    n, q = POSITION_N, POSITION_Q
    k = 8 if case == "k8" else 4
    wm = {"wm1": 1, "wm4": 4}.get(case, 2)
    cpb = 40 if case == "cpb40" else 8
    iters = {"iters1": 1, "iters3": 3}.get(case, 2)
    f32 = np.float32
    alive = np.arange(n) < 48
    pos = rng.uniform((-4, -4, 0.2), (4, 4, 3), (n, 3))
    inv_mass = np.where(alive, rng.uniform(0.2, 2.0, n), 0.0)
    awake = alive & ((np.arange(n) % 2 == 0) if case == "asleep" else True)

    def unit(m):
        v = rng.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    s_valid = np.repeat(alive, k) & (rng.random(n * k) < 0.8)
    if case == "invalid_rows":
        s_valid &= ~np.isin(np.tile(np.arange(k), n), (1, 2))
    if case == "pairs_only":
        s_valid[:] = False
    static = dict(valid=s_valid, normal=unit(n * k), penetration=rng.uniform(-0.02, 0.08, n * k))

    ea = rng.integers(0, 48, q)
    eb = (ea + rng.integers(1, 48, q)) % 48
    if case == "cpb_limit":
        ea[:9], eb[:9] = 0, np.arange(1, 10)
        ea[9:17], eb[9:17] = 10, np.arange(11, 19)
    if case == "cpb40":
        ea[:40], eb[:40] = 3, np.arange(4, 44)
    if case == "padded_entries":
        ea[: q // 8] = -1
        eb[q // 8: q // 4] = -1
    if case == "static_only":
        ea[:] = -1
        eb[:] = -1
    pa, pb = np.repeat(ea, wm), np.repeat(eb, wm)
    p_valid = (pa >= 0) & (rng.random(q * wm) < 0.85)
    if case == "invalid_rows":
        p_valid &= np.tile(np.arange(wm), q) != 1
    pair = dict(a=pa, b=pb, valid=p_valid, normal=unit(q * wm),
                penetration=rng.uniform(-0.02, 0.08, q * wm))
    occupied = (ea >= 0) if wm > 1 else (p_valid & (ea >= 0))
    cast = (lambda d: {f: np.ascontiguousarray(v.astype(np.int32) if f in ("a", "b") else
                                               v if v.dtype == bool else v.astype(f32))
                       for f, v in d.items()})
    return PositionScene(pos.astype(f32), inv_mass.astype(f32), awake, cast(static), cast(pair),
                         occupied, k, wm, cpb, iters, 0.25, 0.01)


def position_inputs(scene: PositionScene, device):
    """(args, kwargs) of ``positions.solve_positions`` for ``scene`` on
    ``device``; the table from KT's twin on the CPU."""
    t = (lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device))
    wm = scene.wm
    table, sign, _ = layout.incidence_plain(
        torch.as_tensor(scene.pair["a"][::wm].copy()),
        torch.as_tensor(scene.pair["b"][::wm].copy()), torch.as_tensor(scene.occupied),
        scene.pos.shape[0], scene.cpb)
    st, pr = scene.static, scene.pair
    args = (t(scene.pos), t(scene.inv_mass), t(scene.awake),
            (t(st["valid"]), t(st["normal"]), t(st["penetration"])),
            (t(pr["a"]), t(pr["b"]), t(pr["valid"]), t(pr["normal"]), t(pr["penetration"])),
            table.to(device), sign.to(device), torch.tensor(scene.slop, device=device))
    return args, dict(iters=scene.iters, beta=scene.beta, wm=wm)


# ---------------------------------------------------------------------------
# KO: hull-contact scenes.
# ---------------------------------------------------------------------------

CONVEX_CASES = ("every_code", "mesh_step", "all_empty", "all_full", "ragged", "cube_ties",
                "bias_ties", "margin_ties", "separated", "sensors", "hull_32", "blocked_wm4")
_CONVEX_CODES = (3, 7, 11, 12, 13, 14, 15)
_CONVEX_WIDTH = {3: 1, 7: 4, 11: 2, 12: 1, 13: 4, 14: 2, 15: 4}   # narrowphase._MANIFOLD_WIDTH
_CUBE = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5) for z in (-.5, .5)],
                 np.float32)


def _prism(sides=16, radius=0.5, half_height=0.3):
    """A ``sides``-gon prism: 2 * sides vertices (32: the kernel's most),
    sides + 2 faces."""
    a = np.linspace(0.0, 2.0 * np.pi, sides + 1)[:-1]
    ring = np.stack([np.cos(a) * radius, np.sin(a) * radius], 1)
    return np.concatenate([np.concatenate([ring, np.full((sides, 1), z)], 1)
                           for z in (-half_height, half_height)]).astype(np.float32)


def convex_hulls():
    """The scenes' hull library, in slot order: a unit cube, an octahedron,
    a 60-point cloud (seed 9), a tetrahedron and the 32-vertex prism."""
    octa = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32) * 0.6
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32) * 0.8
    cloud = (np.random.default_rng(9).normal(size=(60, 3)) * 0.4).astype(np.float32)
    return [_CUBE, octa, cloud, tet, _prism()]


@dataclasses.dataclass
class ConvexScene:
    """KO's inputs (numpy): the bodies (BodyState fields), the hull library
    (``convex_library(convex_hulls())``) and the buckets [(code, ba, bb,
    bvalid)] with their widths and layout."""
    bodies: dict
    library: dict
    buckets: list
    wm: tuple
    blocked: bool = False


def convex_library(hull_verts):
    """The library arrays (verts [64, 32, 3], n_verts, planes [64, 32, 4],
    n_faces) of ``hull_verts`` interned by a world, in order."""
    from substrata_tpu_torch import PhysicsWorld
    from substrata_tpu_torch.physics import shapes
    from substrata_tpu_torch.physics.state import SimConfig
    w = PhysicsWorld(SimConfig(capacity=8, max_pairs=32, grid_dim=8), device="cpu")
    for v in hull_verts:
        w._intern_hull(shapes.make_convex_hull(v))
    return {k: v.copy() for k, v in w._hull_host.items()}


def _cx_params(rng, st, n, hulls=(0, 1, 2, 3), scale=1.0):
    """Shape params of ``n`` bodies of shape type ``st`` (a hull's: its
    library slot, drawn from ``hulls``)."""
    if st == 3:
        prm = np.zeros((n, 4), np.float32)
        prm[:, 0] = rng.choice(np.asarray(hulls), n)
        return prm
    return _cf_shape(rng, st, n) * np.float32(scale)


def _cx_side(rng, st, n, spread=0.7, hulls=(0, 1, 2, 3)):
    return (rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
            _unit_quats(rng, n).astype(np.float32), np.full(n, st, np.int32),
            _cx_params(rng, st, n, hulls))


def _cx_buckets(rng, spec, occupied=0.9, sensor_frac=0.02, spread=0.7, hulls=(0, 1, 2, 3)):
    """Bodies and buckets of distinct random pairs: ``spec`` [(code, slots)],
    side a's bodies then side b's for each bucket; the empty slots keep
    their pair's bodies (as KT's grouping leaves stale ids)."""
    sides, buckets, base = [], [], 0
    for code, n in spec:
        sides += [_cx_side(rng, code // 4, n, spread, hulls),
                  _cx_side(rng, code % 4, n, spread, hulls)]
        ba = np.arange(base, base + n, dtype=np.int32)
        buckets.append((code, ba, ba + n, rng.random(n) < occupied))
        base += 2 * n
    return _cf_bodies(rng, sides, sensor_frac), buckets


def _cx_seps(code, side_a, side_b, library):
    """(best face of A, best face of B, best auxiliary axis) of KO's twin's
    SAT on one code's pairs, in its operations and order (written out here
    from ``convex_rep`` and ``_face_seps``: the bench scripts run these
    scenes through a parent checkout's twin as well)."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.kernels import convex as ko
    from substrata_tpu_torch.kernels.closed_forms import safe_normalize
    from substrata_tpu_torch.maths import quat as quatm
    lib = convert.hull_library_from_numpy(library, device="cpu")
    t = [torch.as_tensor(np.ascontiguousarray(x))
         for x in (side_a[0], side_a[1], side_a[3], side_b[0], side_b[1], side_b[3])]
    pa, qa, pra, pb, qb, prb = t
    wa, ma, ra, pla, pma = ko.convex_rep(code // 4, pa, qa, pra, lib)
    wb, mb, rb, plb, pmb = ko.convex_rep(code % 4, pb, qb, prb, lib)
    sep_a = ko._face_seps(pla, pma, wb, mb, rb)
    sep_b = ko._face_seps(plb, pmb, wa, ma, ra)
    diff = wa[:, :, None, :] - wb[:, None, :, :]
    d2 = torch.where(ma[:, :, None] & mb[:, None, :], quatm.dot3(diff, diff), ko.POS)
    flat = torch.argmin(d2.reshape(d2.shape[0], -1), dim=1)
    ia, ib = flat // wb.shape[1], flat % wb.shape[1]
    rows = torch.arange(wa.shape[0])
    aux = torch.stack([safe_normalize(wb[rows, ib] - wa[rows, ia]), safe_normalize(pb - pa)], 1)
    pa_dot = torch.where(ma[:, None, :], quatm.dot3(wa[:, None, :, :], aux[:, :, None, :]),
                         ko.NEG)
    pb_dot = torch.where(mb[:, None, :], quatm.dot3(wb[:, None, :, :], aux[:, :, None, :]),
                         ko.POS)
    sep_aux = (pb_dot.min(dim=2).values - rb[:, None]) - (pa_dot.max(dim=2).values + ra[:, None])
    return sep_a.max(dim=1).values, sep_b.max(dim=1).values, sep_aux.max(dim=1).values


def _cx_ties(rng, code, kind, m, library, pool=8, steps=48):
    """m pairs of ``code`` set at a SAT decision's threshold, as
    ``_nearest_ties`` sets KA's: each of m * pool random pairs slides along
    its offset until the decision changes sign, then the scale is bisected
    to float32 rounding.  ``bias``: the auxiliary axis against the better
    face (best_x against best_face * 0.98 + 0.001) or, where no pair of the
    pool changes that, face B against face A; ``margin``: the separation
    against the 4 cm margin."""
    a = _cx_side(rng, code // 4, m * pool, 0.0)
    b = _cx_side(rng, code % 4, m * pool, 0.9)
    off = b[0] - a[0]

    def decision(scale, which):
        sb = (a[0] + off * scale[:, None].astype(np.float32),) + b[1:]
        fa, fb, x = _cx_seps(code, a, sb, library)
        if which == "margin":
            d = torch.maximum(torch.maximum(fa, fb), x) - 0.04
        elif which == "aux":
            d = x - (torch.maximum(fa, fb) * 0.98 + 0.001)
        else:
            d = fb - (fa * 0.98 + 0.001)
        return d.double().numpy()
    lo, hi = np.full(m * pool, 0.2), np.full(m * pool, 1.8)
    for which in (("aux", "faces") if kind == "bias" else ("margin",)):
        f_lo, f_hi = decision(lo, which), decision(hi, which)
        keep = np.flatnonzero(np.sign(f_lo) != np.sign(f_hi))[:m]
        if len(keep):
            break
    lo, hi, f_lo = lo[keep], hi[keep], f_lo[keep]
    a = tuple(x[keep] for x in a)
    b = tuple(x[keep] for x in b)
    off = off[keep]
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        f_mid = decision(mid, which)
        left = np.sign(f_mid) == np.sign(f_lo)
        lo, f_lo = np.where(left, mid, lo), np.where(left, f_mid, f_lo)
        hi = np.where(left, hi, mid)
    return a, (a[0] + off * lo[:, None].astype(np.float32),) + b[1:]


def convex_scene(case: str, seed: int = 0) -> ConvexScene:
    """The inputs of one hard hull-contact case; pairs within touching range
    (about half in contact), 90% of the slots occupied and 2% of the
    bodies sensors unless named, hulls from ``convex_hulls()`` 0-3, the
    compacted layout (each code's own width) unless named:

    - ``every_code``: one bucket of 160 slots for each hull code;
    - ``mesh_step``: a mesh world's step, codes 11, 14 and 15 at 512, 512
      and 2,048 slots, 3% occupied;
    - ``all_empty``: codes 7 and 15 at 256 and 1,024 slots, none occupied;
    - ``all_full``: codes 13 and 15 at 256 and 512 slots, every slot
      occupied;
    - ``ragged``: codes 3, 11, 12, 14 and 15 at 1, 31, 33, 97 and 130
      slots (not multiples of 4 or 32);
    - ``cube_ties``: cube hulls on cube hulls and boxes, face to face and
      axis-aligned, a few mm in (four incident vertices at one depth);
    - ``bias_ties``, ``margin_ties``: codes 7, 14 and 15, pairs slid along
      their offset until the axis choice (the 0.98 bias) or the separation
      (the 4 cm margin) sits at its threshold, to float32 rounding;
    - ``separated``: every code, pairs 2.5-4 m apart;
    - ``sensors``: codes 13 and 15, a sensor on side a, on side b, on both
      and on neither;
    - ``hull_32``: the 32-vertex prism against hulls, boxes, spheres and
      capsules (codes 15, 13, 3, 11);
    - ``blocked_wm4``: every code at 96 slots, the pair-blocked layout at
      width 4 (empty slots a = -1).
    """
    if case not in CONVEX_CASES:
        raise ValueError(f"unknown convex case {case!r}")
    rng = np.random.default_rng(seed + 400 + CONVEX_CASES.index(case))
    library = convex_library(convex_hulls())
    blocked, wm_all = False, None
    if case == "every_code":
        bodies, buckets = _cx_buckets(rng, [(c, 160) for c in _CONVEX_CODES])
    elif case == "mesh_step":
        bodies, buckets = _cx_buckets(rng, [(11, 512), (14, 512), (15, 2048)], occupied=0.03)
    elif case == "all_empty":
        bodies, buckets = _cx_buckets(rng, [(7, 256), (15, 1024)], occupied=0.0)
    elif case == "all_full":
        bodies, buckets = _cx_buckets(rng, [(13, 256), (15, 512)], occupied=1.0)
    elif case == "ragged":
        bodies, buckets = _cx_buckets(rng, list(zip((3, 11, 12, 14, 15), (1, 31, 33, 97, 130))))
    elif case == "cube_ties":
        sides, buckets, base = [], [], 0
        for code in (15, 13, 7):
            n = 128
            pa = np.zeros((n, 3), np.float32)
            pb = np.zeros((n, 3), np.float32)
            pb[:, :2] = rng.uniform(-0.3, 0.3, (n, 2))
            prm_a = _cx_params(rng, code // 4, n, hulls=(0,))
            prm_b = _cx_params(rng, code % 4, n, hulls=(0,))
            ha = 0.5 if code // 4 == 3 else prm_a[:, 2]
            hb = 0.5 if code % 4 == 3 else prm_b[:, 2]
            pb[:, 2] = ha + hb - rng.choice(np.array([0.0, 0.002, 0.005, 0.01], np.float32), n)
            ident = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (n, 1))
            sides += [(pa, ident, np.full(n, code // 4, np.int32), prm_a),
                      (pb, ident.copy(), np.full(n, code % 4, np.int32), prm_b)]
            ba = np.arange(base, base + n, dtype=np.int32)
            buckets.append((code, ba, ba + n, np.ones(n, bool)))
            base += 2 * n
        bodies = _cf_bodies(rng, sides)
    elif case in ("bias_ties", "margin_ties"):
        sides, buckets, base = [], [], 0
        for code in (7, 14, 15):
            n = 64
            sa, sb = _cx_ties(rng, code, case[:-5] if case == "bias_ties" else "margin", n,
                              library)
            n = sa[0].shape[0]
            sides += [sa, sb]
            ba = np.arange(base, base + n, dtype=np.int32)
            buckets.append((code, ba, ba + n, np.ones(n, bool)))
            base += 2 * n
        bodies = _cf_bodies(rng, sides)
    elif case == "separated":
        bodies, buckets = _cx_buckets(rng, [(c, 64) for c in _CONVEX_CODES])
        for _, ba, bb, _ in buckets:
            d = rng.normal(size=(len(ba), 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            bodies["pos"][bb] = bodies["pos"][ba] + (d * rng.uniform(2.5, 4.0, (len(ba), 1))
                                                     ).astype(np.float32)
    elif case == "sensors":
        bodies, buckets = _cx_buckets(rng, [(13, 128), (15, 128)], sensor_frac=0.0)
        for _, ba, bb, _ in buckets:
            kind = np.arange(ba.shape[0]) % 4
            bodies["is_sensor"][ba[kind == 1]] = True
            bodies["is_sensor"][bb[kind == 2]] = True
            bodies["is_sensor"][ba[kind == 3]] = True
            bodies["is_sensor"][bb[kind == 3]] = True
    elif case == "hull_32":
        sides, buckets, base = [], [], 0
        for code in (15, 13, 3, 11):
            n = 96
            prism_first = code // 4 == 3
            a = _cx_side(rng, code // 4, n, 0.0, hulls=(4,) if prism_first else (0, 1, 2, 3))
            b = _cx_side(rng, code % 4, n, 0.8, hulls=(0, 1, 2, 3) if prism_first else (4,))
            sides += [a, b]
            ba = np.arange(base, base + n, dtype=np.int32)
            buckets.append((code, ba, ba + n, rng.random(n) < 0.9))
            base += 2 * n
        bodies = _cf_bodies(rng, sides)
    else:   # blocked_wm4
        bodies, buckets = _cx_buckets(rng, [(c, 96) for c in _CONVEX_CODES], occupied=0.7)
        blocked, wm_all = True, 4
    wm = tuple(wm_all or _CONVEX_WIDTH[c] for c, *_ in buckets)
    return ConvexScene(bodies=bodies, library=library, buckets=buckets, wm=wm, blocked=blocked)


def convex_inputs(scene: ConvexScene, device):
    """``convex.convex_buckets``' arguments for ``scene`` on ``device``:
    (buckets [(code, ba, bb, bvalid)], wm, blocked, pos, quat, shape_params,
    friction, restitution, is_sensor, hulls); the buckets' ba, bb and
    bvalid views of one array each, in bucket order (as KT's grouping lays
    them out)."""
    from substrata_tpu_torch import convert
    body = convert.body_state_from_numpy(scene.bodies, device=device)
    sizes = [b[1].shape[0] for b in scene.buckets]
    ba, bb, bv = (torch.as_tensor(np.concatenate([b[i] for b in scene.buckets]), device=device)
                  for i in (1, 2, 3))
    buckets = [(c, *(t.split(sizes)[k] for t in (ba, bb, bv)))
               for k, (c, *_) in enumerate(scene.buckets)]
    return (buckets, scene.wm, scene.blocked, body.pos, body.quat, body.shape_params,
            body.friction, body.restitution, body.is_sensor,
            convert.hull_library_from_numpy(scene.library, device=device))


# ---------------------------------------------------------------------------
# KZ: pose scenes.
# ---------------------------------------------------------------------------

POSE_CASES = ("j1", "j63", "j64", "j65", "j256", "clip_edges", "every_option", "padded")


@dataclasses.dataclass
class PoseScene:
    """KZ's inputs (numpy): a skeleton (names, parents, rest translation,
    rotation and scale, topologically ordered), its clips [(name, rot [F,
    J, 4], trans [F, J, 3], looping)] and the avatars' pose arrays
    (``anim.pose.zero_pose_arrays``' keys)."""
    names: list
    parents: np.ndarray
    rest_trans: np.ndarray
    rest_rot: np.ndarray
    rest_scale: np.ndarray
    clips: list
    arrays: dict


def _pose_skeleton(rng, nj):
    """The default humanoid's first ``nj`` joints (its 64 hold every slot
    and finger), or the humanoid and ``nj - 64`` more joints hung from
    random earlier ones.  A lone joint is named outside the procedural
    slots: the reference writes every missing slot's row onto joint 0 in
    one scatter, whose order XLA leaves open where a slot's row is joint
    0's own."""
    from substrata_tpu_torch.anim import build_default_humanoid
    sk = build_default_humanoid()
    names = list(sk.names[:nj]) if nj > 1 else ["Root"]
    parents = sk.parents[:nj].copy()
    trans, rot, scale = sk.rest_trans[:nj].copy(), sk.rest_rot[:nj].copy(), \
        sk.rest_scale[:nj].copy()
    extra = nj - len(names)
    if extra > 0:
        names += [f"Extra{k}" for k in range(extra)]
        parents = np.concatenate([parents, [rng.integers(0, len(sk.names) + k)
                                            for k in range(extra)]]).astype(np.int32)
        trans = np.concatenate([trans, rng.uniform(-0.2, 0.2, (extra, 3))])
        rot = np.concatenate([rot, _unit_quats(rng, extra)])
        scale = np.concatenate([scale, rng.uniform(0.8, 1.2, (extra, 3))])
    f32 = np.float32
    return names, parents.astype(np.int32), trans.astype(f32), rot.astype(f32), scale.astype(f32)


def _pose_clips(rng, nj):
    """Six clips of random unit rotations and translations: looping and
    clamped, 1 to 96 frames."""
    out = []
    for k, (frames, loop) in enumerate(((24, True), (96, True), (1, True), (40, False),
                                        (1, False), (57, False))):
        rot = _unit_quats(rng, frames * nj).reshape(frames, nj, 4).astype(np.float32)
        trans = rng.uniform(-0.3, 0.3, (frames, nj, 3)).astype(np.float32)
        out.append((f"clip{k}", rot, trans, loop))
    return out


def pose_scene(case: str, seed: int = 0) -> PoseScene:
    """The inputs of one hard pose case (8 avatars with every option at
    random, as ``tests/test_torch_anim.py:random_pose_arrays`` draws them,
    unless named):

    - ``j1``, ``j63``, ``j64``, ``j65``, ``j256``: skeletons of 1, 63, 64,
      65 and 256 joints (the humanoid cut or extended; 65 and 256 take the
      block's 1,024 threads in 2 and 4 groups of joints; the lone joint
      named outside the slots);
    - ``clip_edges``: the humanoid, every clip at frames -1, -0.5, 0, its
      last frame, half a frame past it, its count and one past, looping and
      clamped, every option off;
    - ``every_option``: the humanoid, each slot's override alone, each
      slot's post rotation alone, both on a slot, grabs at 0, 5e-4, 1e-3
      (not above the threshold), 1.5e-3 and 1 on either hand;
    - ``padded``: 37 avatars with every option, padded to 64 with neutral
      rows (``pose_all``'s padding).
    """
    from substrata_tpu_torch.anim import pose as apose
    if case not in POSE_CASES:
        raise ValueError(f"unknown pose case {case!r}")
    rng = np.random.default_rng(seed + 500 + POSE_CASES.index(case))
    nj = int(case[1:]) if case.startswith("j") else 64
    skel = _pose_skeleton(rng, nj)
    clips = _pose_clips(rng, nj)
    nc, s = len(clips), apose.NUM_SLOTS

    def random_arrays(a):
        arr = apose.zero_pose_arrays(a)
        arr["clip_a"][:] = rng.integers(0, nc, a)
        arr["clip_b"][:] = rng.integers(0, nc, a)
        arr["frame_a"][:] = rng.uniform(-5.0, 120.0, a)
        arr["frame_b"][:] = rng.uniform(-5.0, 120.0, a)
        arr["blend"][:] = rng.uniform(0.0, 1.0, a)
        for k in ("override_rot", "post_rot"):
            arr[k][:] = _unit_quats(rng, a * s).reshape(a, s, 4)
        arr["override_mask"][:] = rng.random((a, s)) < 0.4
        arr["post_mask"][:] = rng.random((a, s)) < 0.5
        for k in ("grab_l", "grab_r"):
            g = rng.uniform(0.0, 1.0, a)
            g[::5], g[1::7] = 0.0, 5e-4
            arr[k][:] = g
        q = _unit_quats(rng, a)
        for i in range(a):
            arr["root"][i, :3, :3] = _quat_rot3(q[i])
            arr["root"][i, :3, 3] = rng.uniform(-50, 50, 3)
        return arr

    if case == "clip_edges":
        rows = []
        for c, (_, rot, _, loop) in enumerate(clips):
            f = rot.shape[0]
            for frame in (-1.0, -0.5, 0.0, f - 1.0, f - 0.5, float(f), f + 1.0):
                rows.append((c, frame))
        arr = apose.zero_pose_arrays(len(rows))
        arr["clip_a"][:] = [c for c, _ in rows]
        arr["frame_a"][:] = [f for _, f in rows]
        arr["clip_b"][:] = arr["clip_a"][::-1]
        arr["frame_b"][:] = arr["frame_a"][::-1]
        arr["blend"][:] = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), len(rows))
    elif case == "every_option":
        grabs = np.array([0.0, 5e-4, 1e-3, 1.5e-3, 1.0], np.float32)
        a = 3 * s + 2 * len(grabs)
        arr = random_arrays(a)
        arr["override_mask"][:] = False
        arr["post_mask"][:] = False
        arr["grab_l"][:] = arr["grab_r"][:] = 0.0
        for k in range(s):
            arr["override_mask"][k, k] = True
            arr["post_mask"][s + k, k] = True
            arr["override_mask"][2 * s + k, k] = arr["post_mask"][2 * s + k, k] = True
        for k, g in enumerate(grabs):
            arr["grab_l"][3 * s + k] = g
            arr["grab_r"][3 * s + len(grabs) + k] = g
    elif case == "padded":
        part = random_arrays(37)
        arr = apose.zero_pose_arrays(64)
        for k in arr:
            arr[k][:37] = part[k]
    else:
        arr = random_arrays(8)
    return PoseScene(*skel, clips=clips, arrays=arr)


def _quat_rot3(q):
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                    np.float32)


def pose_inputs(scene: PoseScene, device):
    """``kernels.pose.pose``'s arguments for ``scene`` on ``device``: (bank,
    rig, params), built as the port's ``PoseKernel`` builds them."""
    from substrata_tpu_torch.anim import pose as apose
    from substrata_tpu_torch.anim.clips import AnimationClip, ClipBank
    from substrata_tpu_torch.anim.skeleton import Skeleton
    skel = Skeleton(list(scene.names), scene.parents, scene.rest_trans, scene.rest_rot,
                    scene.rest_scale)
    bank = ClipBank(skel, [AnimationClip(n, r, t, loop) for n, r, t, loop in scene.clips],
                    device=device)
    return (bank, apose.build_rig(skel, device=device),
            apose.pose_params_from_arrays(scene.arrays, device=device))


# ---------------------------------------------------------------------------
# KAD: halo-exchange scenes.
# ---------------------------------------------------------------------------

HALO_CASES = ("none_masked", "exactly_h", "h_minus_1", "h_plus_1", "all_masked", "h_is_rows",
              "on_thresholds", "dead_nan_edge", "ragged_rows", "s1", "s2", "s8", "tiles")


@dataclasses.dataclass
class HaloScene:
    """KAD's inputs: a partitioned state's 23 BodyState fields [S rows_in]
    (numpy), the mesh's shape ((S,) x-slabs, or (px, py) tiles, tile index
    x-major), rows a shard, H, the halo width and each axis's extent."""
    fields: dict
    shape: tuple
    rows_in: int
    halo: int
    halo_width: float
    extent: tuple      # (x_min, x_max), or (x_min, x_max, y_min, y_max) for tiles


def _halo_fields(rng, n):
    """Every BodyState field at random (the exchange moves bytes, so each
    field's own values show a misplaced row), alive 90%."""
    f32 = np.float32
    q = rng.normal(size=(n, 4))
    return dict(
        pos=rng.uniform(-1.0, 1.0, (n, 3)).astype(f32),
        quat=(q / np.linalg.norm(q, axis=1, keepdims=True)).astype(f32),
        linvel=rng.normal(size=(n, 3)).astype(f32), angvel=rng.normal(size=(n, 3)).astype(f32),
        inv_mass=rng.uniform(0.1, 2.0, n).astype(f32),
        inv_inertia=rng.uniform(0.1, 3.0, (n, 3)).astype(f32),
        friction=rng.uniform(0.0, 1.0, n).astype(f32),
        restitution=rng.uniform(0.0, 1.0, n).astype(f32),
        motion_type=rng.integers(0, 3, n).astype(np.int32),
        layer=rng.integers(0, 4, n).astype(np.int32), is_sensor=rng.random(n) < 0.2,
        shape_type=rng.integers(0, 4, n).astype(np.int32),
        shape_params=rng.uniform(0.1, 1.0, (n, 4)).astype(f32), alive=rng.random(n) < 0.9,
        awake=rng.random(n) < 0.7, sleep_timer=rng.uniform(0.0, 0.6, n).astype(f32),
        gravity_factor=rng.uniform(0.5, 1.5, n).astype(f32),
        linear_damping=rng.uniform(0.0, 0.5, n).astype(f32),
        angular_damping=rng.uniform(0.0, 0.5, n).astype(f32),
        use_zero_linear_drag=rng.random(n) < 0.3, underwater=rng.random(n) < 0.3,
        bound_radius=rng.uniform(0.1, 1.0, n).astype(f32),
        volume=rng.uniform(0.01, 1.0, n).astype(f32))


def _place_counts(rng, x, lo_e, hi_e, lo_t, hi_t, n_high, n_low):
    """x of one shard's rows: ``n_high`` random rows in (hi_t, hi_e),
    ``n_low`` in (lo_e, lo_t), the rest strictly between the thresholds."""
    f32 = np.float32
    rows = rng.permutation(x.shape[0])
    hi_rows, lo_rows, mid = rows[:n_high], rows[n_high:n_high + n_low], rows[n_high + n_low:]
    x[hi_rows] = rng.uniform(np.nextafter(hi_t, f32(1e9)), hi_e, n_high)
    x[lo_rows] = rng.uniform(lo_e, np.nextafter(lo_t, f32(-1e9)), n_low)
    x[mid] = rng.uniform(np.nextafter(lo_t, f32(1e9)), np.nextafter(hi_t, f32(-1e9)), mid.size)
    return hi_rows, lo_rows


def halo_scene(case: str, seed: int = 0) -> HaloScene:
    """4 x-slabs over [-8, 8] m of 256 rows each, H = 96, 1 m wide, every
    field at random, 10% of the rows dead, unless the case says otherwise:

    - ``none_masked``: every row strictly between its shard's thresholds;
    - ``exactly_h``, ``h_minus_1``, ``h_plus_1``: H, H - 1 and H + 1 alive
      rows past each threshold of every shard (overflow 1 at H + 1);
    - ``all_masked``: a 4.5 m halo over 4 m slabs, so every alive row is
      in both masks;
    - ``h_is_rows``: H = rows_in;
    - ``on_thresholds``: rows on each threshold and one ulp either side
      (strict comparisons: the ones on it stay home);
    - ``dead_nan_edge``: dead rows past the thresholds and alive rows whose
      coordinate (or only another field) is NaN, at the thresholds' rows;
    - ``ragged_rows``: 1,061 rows a shard (not a multiple of 32 or 1,024),
      H = 300;
    - ``s1``, ``s2``, ``s8``: 1, 2 and 8 slabs of 4 m (an axis of one shard
      receives zeros on both sides);
    - ``tiles``: 2 x 2 tiles over [-8, 8]^2, 1.5 m, both phases.
    """
    from substrata_tpu_torch.kernels.halo import thresholds
    if case not in HALO_CASES:
        raise ValueError(f"unknown halo case {case!r}")
    rng = np.random.default_rng(seed + 700 + HALO_CASES.index(case))
    f32 = np.float32
    s = {"s1": 1, "s2": 2, "s8": 8}.get(case, 4)
    rows_in = 1_061 if case == "ragged_rows" else 256
    halo = {"ragged_rows": 300, "h_is_rows": rows_in}.get(case, 96)
    hw = {"all_masked": 4.5, "tiles": 1.5}.get(case, 1.0)
    x_min, x_max = -2.0 * s, 2.0 * s
    n = s * rows_in
    fields = _halo_fields(rng, n)
    if case == "tiles":
        ext = (-8.0, 8.0, -8.0, 8.0)
        tx, ty = np.divmod(np.arange(n) // rows_in, 2)
        fields["pos"][:, 0] = (-8.0 + 8.0 * tx + rng.uniform(0.0, 8.0, n)).astype(f32)
        fields["pos"][:, 1] = (-8.0 + 8.0 * ty + rng.uniform(0.0, 8.0, n)).astype(f32)
        return HaloScene(fields, (2, 2), rows_in, halo, hw, ext)
    w = (x_max - x_min) / s
    lo_t, hi_t = thresholds(x_min, x_max, s, hw)
    x = fields["pos"][:, 0]
    for d in range(s):
        blk = slice(d * rows_in, (d + 1) * rows_in)
        xd = x[blk]
        lo_e, hi_e = f32(x_min + d * w), f32(x_min + (d + 1) * w)
        xd[:] = rng.uniform(lo_e, hi_e, rows_in)
        count = {"none_masked": 0, "exactly_h": halo, "h_minus_1": halo - 1,
                 "h_plus_1": halo + 1}.get(case)
        if count is not None:
            _place_counts(rng, xd, lo_e, hi_e, lo_t[d], hi_t[d], count, count)
            if count:
                fields["alive"][blk] = True
        if case in ("on_thresholds", "dead_nan_edge"):
            rows = rng.permutation(rows_in)[:12]
            for j, t in enumerate((lo_t[d], hi_t[d])):
                for k, v in enumerate((np.nextafter(t, f32(-1e9)), t, np.nextafter(t, f32(1e9)))):
                    xd[rows[6 * j + 2 * k:6 * j + 2 * k + 2]] = v
            if case == "dead_nan_edge":
                alive = fields["alive"][blk]
                alive[rows[:6]] = False                         # dead, past a threshold
                alive[rows[6:]] = True
                xd[rows[6:8]] = np.nan                          # alive, coordinate NaN
                fields["linvel"][blk][rows[8:10], 1] = np.nan   # alive, NaN elsewhere
                fields["sleep_timer"][blk][rows[10]] = np.nan
    return HaloScene(fields, (s,), rows_in, halo, hw, (x_min, x_max))


def halo_inputs(scene: HaloScene, device):
    """(state on ``device``, S, H, phases): each phase is the (axis, stride,
    n_axis, low thresholds, high thresholds) of one ``halo.exchange`` call;
    the tiles' y phase takes the x phase's combined state."""
    from substrata_tpu_torch import convert
    from substrata_tpu_torch.kernels.halo import thresholds
    body = convert.body_state_from_numpy(scene.fields, device=device)
    if len(scene.shape) == 1:
        s = scene.shape[0]
        return body, s, scene.halo, [(0, 1, s) + thresholds(*scene.extent, s,
                                                             scene.halo_width)]
    px, py = scene.shape
    x_lo, x_hi, y_lo, y_hi = scene.extent
    return body, px * py, scene.halo, [
        (0, py, px) + thresholds(x_lo, x_hi, px, scene.halo_width),
        (1, 1, py) + thresholds(y_lo, y_hi, py, scene.halo_width)]


# ---------------------------------------------------------------------------
# KV: sleep-pass scenes.
# ---------------------------------------------------------------------------

SLEEP_CASES = ("cpb1", "cpb8", "cpb16", "cpb40", "wm1", "wm2", "wm4", "slots_full",
               "invalid_entries", "static_counterpart", "nan_velocities", "nan_lambda",
               "fast_wake", "nan_fast_wake", "fast_and_nan", "kinematic", "all_asleep", "n1",
               "n33", "n65536")


@dataclasses.dataclass
class SleepScene:
    """The sleep pass's inputs (numpy): the bodies' awake, previous awake,
    timer, alive and motion type [N], velocities [N, 3]; the static rows
    (valid, penetration) [N K]; the pair rows (a, b, valid, penetration)
    [Q wm] and impulses [Q, wm]; the entries' occupancy; CPB, steps_left."""
    awake: np.ndarray
    prev_awake: np.ndarray
    timer: np.ndarray
    alive: np.ndarray
    motion: np.ndarray
    linvel: np.ndarray
    angvel: np.ndarray
    static: dict
    pair: dict
    lam: np.ndarray
    occupied: np.ndarray
    cpb: int
    steps_left: int


def sleep_scene(case: str, seed: int = 0) -> SleepScene:
    """64 bodies (58 alive: 48 dynamic, 5 kinematic, 5 static), 96 entries
    of wm = 2 rows, K = 4 static rows a body, CPB = 8, speeds about the
    0.03 m/s threshold and up to 2 m/s, impulses about 1e-4, penetrations
    about 0.1, 60% awake, timers about the 0.5 s limit, steps_left 3,
    unless the case says otherwise:

    - ``cpb1``, ``cpb8``, ``cpb16``, ``cpb40``: CPB 1, 8, 16 and 40 (one body in
      all 40: lanes take two rounds);
    - ``wm1``, ``wm2``, ``wm4``: rows an entry (wm 1: invalid rows not tabled);
    - ``slots_full``: each body in exactly CPB entries;
    - ``invalid_entries``: a third of the entries with every row invalid;
    - ``static_counterpart``: a quarter of the entries with b = -1;
    - ``nan_velocities``, ``nan_lambda``: NaN speeds on some bodies, NaN
      impulses and penetrations on some valid rows;
    - ``fast_wake``: body 0 asleep at 2 m/s, touching body 1 awake at 3
      m/s: woken fast (steps_left 0); ``nan_fast_wake``: body 2 so, at a NaN
      speed (steps_left kept); ``fast_and_nan``: both (NaN wins);
    - ``kinematic``: half the bodies kinematic, speeds about the 1e-5 rule;
    - ``all_asleep``: every body asleep, nothing fast;
    - ``n1``, ``n33``: 1 and 33 bodies;
    - ``n65536``: 65,536 bodies and 16,383 entries (the 32-bit incidence
      key's most at that capacity).
    """
    if case not in SLEEP_CASES:
        raise ValueError(f"unknown sleep case {case!r}")
    rng = np.random.default_rng(seed + 800 + SLEEP_CASES.index(case))
    f32 = np.float32
    n = {"n1": 1, "n33": 33, "n65536": 65_536}.get(case, 64)
    q = {"n1": 2, "n33": 48, "n65536": 16_383, "slots_full": 4 * 64}.get(case, 96)
    cpb = {"cpb1": 1, "cpb16": 16, "cpb40": 40}.get(case, 8)
    wm = {"wm1": 1, "wm4": 4}.get(case, 2)
    k = 4
    alive = rng.random(n) < 0.9
    motion = np.full(n, 2, np.int32)
    kinds = rng.random(n)
    motion[kinds < (0.5 if case == "kinematic" else 0.08)] = 1
    motion[kinds > 0.92] = 0
    awake = rng.random(n) < (0.0 if case == "all_asleep" else 0.6)
    prev_awake = np.where(rng.random(n) < 0.85, awake, ~awake)
    if case == "all_asleep":
        prev_awake[:] = False
    timer = rng.uniform(0.3, 0.6, n).astype(f32)

    def speeds(m, scale):
        v = rng.normal(size=(m, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return (v * scale[:, None]).astype(f32)
    slow = rng.random(n) < 0.6
    lscale = np.where(slow, rng.uniform(0.0, 0.04, n), rng.uniform(0.05, 2.0, n))
    ascale = np.where(slow, rng.uniform(0.0, 0.04, n), rng.uniform(0.05, 2.0, n))
    if case == "kinematic":
        lscale = np.where(motion == 1, rng.uniform(0.0, 2e-5, n), lscale)
        ascale = np.where(motion == 1, rng.uniform(0.0, 2e-5, n), ascale)
    if case == "all_asleep":
        lscale, ascale = lscale * 0.01, ascale * 0.01
    linvel, angvel = speeds(n, lscale), speeds(n, ascale)

    if case == "slots_full":
        base = np.arange(n)
        ea = np.concatenate([base] * 4)
        eb = np.concatenate([(base + d) % n for d in (1, 2, 3, 4)])
    else:
        ea = rng.integers(0, n, q)
        eb = (ea + rng.integers(1, max(n, 2), q)) % n if n > 1 else np.full(q, -1)
    if case == "cpb40":
        ea[:41], eb[:41] = 3, np.arange(4, 45)
    if case == "static_counterpart":
        eb[rng.random(q) < 0.25] = -1
    if n > 1 and case not in ("slots_full", "n65536"):
        ea[-q // 8:] = -1                   # padded entries, not in the table
    rows = q * wm
    pa, pb = np.repeat(ea, wm), np.repeat(eb, wm)
    p_valid = (pa >= 0) & (rng.random(rows) < 0.8)
    if case == "invalid_entries":
        p_valid &= np.repeat(rng.random(q) < 0.67, wm)
    lam = rng.uniform(0.0, 2e-4, rows).astype(f32)
    pen = rng.uniform(-0.05, 0.12, rows).astype(f32)
    if case == "nan_lambda":
        lam[rng.random(rows) < 0.1] = np.nan
        pen[rng.random(rows) < 0.1] = np.nan
    if case == "nan_velocities":
        linvel[rng.random(n) < 0.1, 0] = np.nan
        angvel[rng.random(n) < 0.1, 2] = np.nan
    steps = 3
    if case in ("fast_wake", "nan_fast_wake", "fast_and_nan"):
        # Every other newly awake body is slow, so the case decides.
        linvel = np.where(np.linalg.norm(linvel, axis=1, keepdims=True) > 0.9, linvel * 0.4,
                          linvel).astype(f32)
        woken = {"fast_wake": (0,), "nan_fast_wake": (2,), "fast_and_nan": (0, 2)}[case]
        for b in (0, 2):
            alive[b], motion[b], awake[b], prev_awake[b] = True, 2, False, False
            linvel[b] = (2.0, 0.0, 0.0)
        if 2 in woken:
            linvel[2] = (np.nan, 0.0, 0.0)
        for b, partner in ((0, 1), (2, 3)):
            alive[partner], awake[partner] = True, True
            linvel[partner] = (3.0, 0.0, 0.0)
            if b in woken:
                ea[b], eb[b] = b, partner
                p_valid[b * wm:(b + 1) * wm] = True
        pa, pb = np.repeat(ea, wm), np.repeat(eb, wm)
    s_valid = np.repeat(alive, k) & (rng.random(n * k) < 0.3)
    s_pen = rng.uniform(-0.05, 0.12, n * k).astype(f32)
    occupied = (ea >= 0) if wm > 1 else (p_valid & (ea >= 0))
    i32 = np.int32
    return SleepScene(awake, prev_awake, timer, alive, motion, linvel, angvel,
                      dict(valid=s_valid, penetration=s_pen),
                      dict(a=pa.astype(i32), b=pb.astype(i32), valid=p_valid, penetration=pen),
                      lam.reshape(q, wm), occupied, cpb, steps)


def sleep_inputs(scene: SleepScene, device):
    """The arguments of ``sleep.sleep_pass`` for ``scene`` on ``device``:
    (body, prev_awake, linvel, angvel, static rows, pair rows, lambda_p,
    table, sign, wm, dt, params, steps_left); lambda_p a strided view (a
    column of [Q, wm, 3]), as the solver hands it; the table from KT's
    twin on the CPU."""
    from substrata_tpu_torch.physics import state as st
    t = (lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device))
    n = scene.awake.shape[0]
    q, wm = scene.lam.shape
    body = st.zero_body_state(n, device=device).replace(
        awake=t(scene.awake), sleep_timer=t(scene.timer), alive=t(scene.alive),
        motion_type=t(scene.motion))
    table, sign, _ = layout.incidence_plain(
        torch.as_tensor(scene.pair["a"][::wm].copy()),
        torch.as_tensor(scene.pair["b"][::wm].copy()), torch.as_tensor(scene.occupied), n,
        scene.cpb)
    lam3 = torch.zeros((q, wm, 3), dtype=torch.float32, device=device)
    lam3[..., 0] = t(scene.lam)
    pr = scene.pair
    return (body, t(scene.prev_awake), t(scene.linvel), t(scene.angvel),
            (t(scene.static["valid"]), t(scene.static["penetration"])),
            (t(pr["a"]), t(pr["b"]), t(pr["valid"]), t(pr["penetration"])), lam3[..., 0],
            table.to(device), sign.to(device), wm, 1.0 / 60.0,
            st.default_sim_params(device=device),
            torch.tensor(scene.steps_left, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# KM: tick input scenes.
# ---------------------------------------------------------------------------

TICK_IN_CASES = ("no_writes", "writes_128", "slot_n", "vel_mixed", "written_in_region",
                 "all_padded", "one_padded", "all_real", "boundary", "nan_far",
                 "motion_kinds", "n1", "n255", "n257", "n10240", "n65536")


@dataclasses.dataclass
class TickInScene:
    """KM's inputs (numpy): the bodies (BodyState fields) and the tick
    input (``serving_io``'s packed float32 buffer)."""
    bodies: dict
    tin: np.ndarray


def _sphere_shell(rng, n, centre, radius):
    """``n`` float32 points on a sphere, each coordinate then moved 0 to
    3 ulps in or out at random."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = (np.asarray(centre, np.float64) + d * np.asarray(radius, np.float64)[:, None])
    p = p.astype(np.float32)
    for _ in range(3):
        step = rng.integers(-1, 2, size=p.shape)
        p = np.where(step > 0, np.nextafter(p, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(p, np.float32(-np.inf)), p))
    return p.astype(np.float32)


def tick_in_scene(case: str, seed: int = 0) -> TickInScene:
    """The inputs of one hard tick-input case, N = 2,048 bodies unless
    named (``n{N}``: 1, 255, 257, 10,240 and 65,536 bodies, either side of
    a 64-body tile and a 256-lane block, the bench world's and the
    capacity tier's), 32 writes at random slots (velocities on half) and
    64 real wake regions (radius 0.2-3 m) unless named:

    - ``no_writes``: every slot = N (dropped);
    - ``writes_128``: 128 writes, every row;
    - ``slot_n``: rows naming N, N + 7, -1 and INT_MIN among the writes
      (each dropped);
    - ``vel_mixed``: 128 writes, vel_ok 1, 0, NaN and -1 in turn;
    - ``written_in_region``: asleep dynamic bodies written into a region's
      centre, and bodies written out of the region they sat in;
    - ``all_padded``, ``one_padded``: every region padded (-1e9, as the
      serving tick sends them), one of 64;
    - ``all_real``: 64 real regions, no padding;
    - ``boundary``: the bodies on spheres of radius (r + bound + 0.3)
      about 8 regions, each coordinate a few ulps in or out, every body
      asleep and dynamic: the squared distance's rounding decides the wake;
    - ``nan_far``: NaN coordinates, bodies 1e9 m out and writes of both,
      against 32 real and 32 padded regions;
    - ``motion_kinds``: static, kinematic and dead bodies in regions, some
      written.

    Bodies are asleep 70% of the time, with random timers; 90% alive, 80%
    of those dynamic; regions and bodies over +-30 m."""
    if case not in TICK_IN_CASES:
        raise ValueError(f"unknown tick-input case {case!r}")
    from substrata_tpu_torch.kernels import serving_io as km
    from substrata_tpu_torch.physics import state
    rng = np.random.default_rng(seed)
    n = int(case[1:]) if case[0] == "n" and case[1:].isdigit() else 2048
    a = {k: v.numpy().copy() for k, v in vars(state.zero_body_state(n, device="cpu")).items()}
    a["pos"][:] = rng.uniform(-30, 30, (n, 3))
    q = rng.normal(size=(n, 4))
    a["quat"][:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    a["linvel"][:] = rng.normal(0.0, 2.0, (n, 3))
    a["angvel"][:] = rng.normal(0.0, 2.0, (n, 3))
    a["awake"][:] = rng.random(n) < 0.3
    a["sleep_timer"][:] = rng.uniform(0, 1, n)
    a["alive"][:] = rng.random(n) < 0.9
    a["motion_type"][:] = np.where(rng.random(n) < 0.8, 2, rng.integers(0, 2, n))
    a["bound_radius"][:] = rng.uniform(0.1, 1.0, n)
    tin = km.empty_tick_in(n)
    idx = tin[km.O_IDX:km.O_POS].view(np.int32)
    pos = tin[km.O_POS:km.O_ROT].reshape(km.TIN_K, 3)
    rot = tin[km.O_ROT:km.O_LV].reshape(km.TIN_K, 4)
    vel = tin[km.O_LV:km.O_VOK]
    vok = tin[km.O_VOK:km.O_CTR]
    ctr = tin[km.O_CTR:km.O_RAD].reshape(km.TIN_R, 3)
    rad = tin[km.O_RAD:]
    k = 128 if case in ("writes_128", "vel_mixed") else min(32, n)
    if case != "no_writes":
        idx[:k] = rng.permutation(n)[:k]
        pos[:k] = rng.uniform(-30, 30, (k, 3))
        r = rng.normal(size=(k, 4)) if k else np.zeros((0, 4))
        rot[:k] = r / np.linalg.norm(r, axis=1, keepdims=True) if k else r
        vel[:6 * k] = rng.normal(0.0, 2.0, 6 * k)
        vok[:k] = np.arange(k) % 2
    ctr[:] = rng.uniform(-30, 30, (km.TIN_R, 3))
    rad[:] = rng.uniform(0.2, 3.0, km.TIN_R)
    if case == "slot_n":
        idx[:4] = (n, n + 7, -1, np.iinfo(np.int32).min)
    elif case == "vel_mixed":
        vok[:k] = np.array([1.0, 0.0, np.nan, -1.0], np.float32)[np.arange(k) % 4]
    elif case == "written_in_region":
        inside = idx[:16]
        a["awake"][inside] = False
        a["motion_type"][inside] = 2
        a["alive"][inside] = True
        pos[:16] = ctr[:16]
        out = idx[16:32]
        a["pos"][out] = ctr[16:32]
        pos[16:32] = ctr[16:32] + 500.0
    elif case == "all_padded":
        rad[:] = -1e9
    elif case == "one_padded":
        rad[37] = -1e9
    elif case == "boundary":
        rad[8:] = 0.5
        ctr[8:] = rng.uniform(500, 600, (km.TIN_R - 8, 3))
        a["awake"][:] = False
        a["alive"][:] = True
        a["motion_type"][:] = 2
        which = rng.integers(0, 8, n)
        br = a["bound_radius"]
        reach = (rad[which] + br) + np.float32(0.3)
        for j in range(8):
            m = which == j
            a["pos"][m] = _sphere_shell(rng, int(m.sum()), ctr[j], reach[m])
        written = idx[:k]
        pos[:k] = a["pos"][written]
    elif case == "nan_far":
        rad[32:] = -1e9
        a["pos"][0::7, 0] = np.nan
        a["pos"][1::7] = np.float32(1e9)
        a["pos"][2::7, 2] = np.float32(-1e9)
        pos[0] = (np.nan, 0.0, 0.0)
        pos[1] = (1e9, 1e9, 1e9)
    elif case == "motion_kinds":
        a["motion_type"][:] = rng.integers(0, 3, n)
        a["alive"][:] = rng.random(n) < 0.6
        a["pos"][:64] = ctr[np.arange(64) % km.TIN_R]
    bodies = {k_: np.ascontiguousarray(v) for k_, v in a.items()}
    return TickInScene(bodies=bodies, tin=tin)


def tick_in_inputs(scene: TickInScene, device):
    """``apply_tick_in``'s arguments for ``scene`` on ``device``: (state,
    tick input)."""
    from substrata_tpu_torch import convert
    return (convert.body_state_from_numpy(scene.bodies, device=device),
            torch.as_tensor(scene.tin, device=device))


# ---------------------------------------------------------------------------
# KF's fetch: scenes, and the fetch that feeds KF's own scenes.
# ---------------------------------------------------------------------------

FETCH_CASES = ("l1", "l2", "l3", "len0_layer", "looping", "stream_head_in_block",
               "negative_playhead", "past_end", "ed0", "ed_max", "row0_clamped", "li_max",
               "inactive", "b16", "b256", "b800", "b1024", "s1", "s33", "s512")
FETCH_POOL = 1 << 17
FETCH_BUF = 20_000
KF_ARGS = SPATIALISE_ARGS[1:]    # KF's arguments after the fetch


@dataclasses.dataclass
class FetchScene:
    """KF's inputs with its fetch (numpy): ``fetch`` by ``FETCH_FIELDS``,
    ``block``, ``kf`` by ``KF_ARGS``, ``use_hrtf`` and ``epilogue`` by
    ``EPILOGUE_OWN`` (the port's ``audio_mix`` names them too; a parent
    port run by the bench scripts may not)."""
    fetch: dict
    block: int
    kf: dict
    use_hrtf: bool
    epilogue: dict


def _kf_arrays(rng, s, b, t=64):
    """KF's own inputs for ``s`` sources and ``b`` frames (as
    ``spatialise_scene`` draws them, samples apart)."""
    f32 = np.float32
    na, ne = SPATIALISE_BANK
    return dict(lp_state=rng.normal(0.0, 0.1, s).astype(f32),
                alpha=rng.choice(np.array([0.1024, 0.3491, 1.0], f32), s),
                use_lp=rng.random(s) < 0.5, spatial=rng.random(s) < 0.75,
                hrir_hist=rng.normal(0.0, 0.1, (s, t - 1)).astype(f32),
                bank=rng.normal(0.0, 0.2, (na, ne, 2, t)).astype(f32),
                dir_idx=rng.integers(0, na * ne, s).astype(np.int32),
                prev_gl=rng.uniform(0, 1, s).astype(f32), prev_gr=rng.uniform(0, 1, s).astype(f32),
                gl=rng.uniform(0, 1, s).astype(f32), gr=rng.uniform(0, 1, s).astype(f32),
                ramp=np.linspace(0.0, 1.0, b, dtype=f32), gain=rng.uniform(0, 1, s).astype(f32),
                send_gain=rng.uniform(0, 1, s).astype(f32))


def _epilogue_own(rng, s):
    return dict(finished=rng.random(s) < 0.1, smoothed_level=rng.uniform(0, 1, s).astype(
        np.float32), alive=rng.random(s) < 0.9, remove_on_finish=rng.random(s) < 0.5)


def fetch_scene(case: str, seed: int = 0) -> FetchScene:
    """64 sources of 3 layers and B = 256 frames unless named (``l{L}``:
    1 to 3 layers; ``b{B}``: 16, 256, 800 and 1,024 frames; ``s{S}``: 1,
    33 and 512 sources, B = 256, the client world's render block), over a
    2^17-sample pool of two sines.  Layer 0 always plays, layers 1-2 of
    a third of the sources too (mix sources), buffers of 4,000-20,000
    samples, rates in [0.5, 2.4], playheads in [0, 3,000), a quarter
    looping, an eighth streaming (write head 40-100 samples past the
    playhead), 80% active:

    - ``len0_layer``: layer 1 of every source with buf_len 0 and a
      non-zero mix factor (its gain is 0);
    - ``looping``: every source looping, playheads past their ends and
      negative;
    - ``stream_head_in_block``: every source streaming, the write head
      inside the block;
    - ``negative_playhead``, ``past_end``: playheads in [-600, 0) and
      past buf_len - 1;
    - ``ed0``, ``ed_max``: rates 0 and DELTA_MAX (2.5);
    - ``row0_clamped``: buffers at the pool's end, so the window row
      clamps at n_rows - nw;
    - ``li_max``: rate DELTA_MAX from the pool's last rows, so the
      in-window position clamps at li_max;
    - ``inactive``: no source active."""
    if case not in FETCH_CASES:
        raise ValueError(f"unknown fetch case {case!r}")
    from substrata_tpu_torch.audio import mix
    rng = np.random.default_rng(seed)
    f32 = np.float32
    s = int(case[1:]) if case[0] == "s" and case[1:].isdigit() else 64
    b = int(case[1:]) if case[0] == "b" and case[1:].isdigit() else 256
    nl = int(case[1:]) if case[0] == "l" and case[1:].isdigit() else 3
    nw = mix.window_rows(b)
    n_rows = FETCH_POOL // 128
    i = np.arange(FETCH_POOL)
    pool = (0.6 * np.sin(i * 0.03) + 0.3 * np.sin(i * 0.0071)).astype(f32)
    buf_len = np.zeros((s, nl), np.int32)
    buf_off = np.zeros((s, nl), np.int32)
    head = np.zeros((s, nl), f32)
    mixf = np.zeros((s, nl), f32)
    mixf[:, 0] = 1.0
    mixers = rng.random(s) < 1 / 3
    for j in range(nl):
        on = np.ones(s, bool) if j == 0 else mixers
        buf_len[:, j] = np.where(on, rng.integers(4000, FETCH_BUF, s), 0)
        buf_off[:, j] = rng.integers(0, FETCH_POOL - FETCH_BUF - 4000, s)
        head[:, j] = rng.uniform(0, 3000, s)
        if j:
            mixf[:, j] = np.where(on, rng.uniform(0.2, 1.0, s), 0.0)
    ed = rng.uniform(0.5, 2.4, (s, nl)).astype(f32)
    looping = rng.random(s) < 0.25
    stream = ~looping & (rng.random(s) < 1 / 6)
    active = rng.random(s) < 0.8
    swh = np.where(stream, head[:, 0] + rng.uniform(40, 100, s), 0.0).astype(f32)
    if case == "len0_layer":
        buf_len[:, 1] = 0
        mixf[:, 1] = rng.uniform(0.2, 1.0, s)
    elif case == "looping":
        looping[:], stream[:] = True, False
        head = np.where(rng.random((s, nl)) < 0.5, buf_len + rng.uniform(1, 500, (s, nl)),
                        -rng.uniform(1, 500, (s, nl))).astype(f32)
    elif case == "stream_head_in_block":
        looping[:], stream[:] = False, True
        swh = (head[:, 0] + rng.uniform(0, 1, s) * ed[:, 0] * b).astype(f32)
    elif case == "negative_playhead":
        head = rng.uniform(-600, 0, (s, nl)).astype(f32)
    elif case == "past_end":
        head = (buf_len + rng.uniform(-1, 300, (s, nl))).astype(f32)
    elif case == "ed0":
        ed[:] = 0.0
    elif case == "ed_max":
        ed[:] = mix.DELTA_MAX
    elif case in ("row0_clamped", "li_max"):
        top = (n_rows - nw) * 128
        buf_off[:] = rng.integers(top - 300, top + (400 if case == "row0_clamped" else 900),
                                  (s, nl))
        head = np.where(looping[:, None], head, rng.uniform(0, 50, (s, nl))).astype(f32)
        if case == "li_max":
            ed[:] = mix.DELTA_MAX
    elif case == "inactive":
        active[:] = False
    fetch = dict(pool=pool, buf_offset=buf_off, buf_len=buf_len, playhead=head, eff_delta=ed,
                 mix_factor=mixf, looping=looping, stream_mode=stream, stream_write_head=swh,
                 active=active)
    return FetchScene(fetch=fetch, block=b, kf=_kf_arrays(rng, s, b), use_hrtf=True,
                      epilogue=_epilogue_own(rng, s))


def _fed(samples, ep, spat, use_hrtf, integer_heads):
    """A FetchScene whose fetch feeds KF ``samples`` [S, B] and the
    epilogue's fields ``ep`` (by EPILOGUE_FIELDS): layer 0 of each source
    plays its own run of the pool, which holds that source's samples, at
    rate 1 from the playhead head - B, so that the fetch's new head is the
    case's (the heads' first column floored with ``integer_heads``: then
    an in-range frame is the sample itself); layers past 0 read elsewhere
    with mix factor 0.  The looping, streaming and active flags and the
    lengths are the case's; a streaming source's write head lies past the
    block."""
    from substrata_tpu_torch.audio import mix
    f32 = np.float32
    s, b = samples.shape
    nl = ep["new_heads"].shape[1]
    rng = np.random.default_rng([s, b, nl])
    h0 = ep["new_heads"][:, 0].astype(f32)
    if integer_heads:
        h0 = np.floor(h0)
    p0 = (h0 - f32(b)).astype(f32)
    stride = ((b + 1) // 128 + 2) * 128
    base = 50_048 + np.arange(s) * stride
    blen = ep["buf_len"].astype(np.int32)
    wrap = ep["looping"] | ep["stream_mode"]
    lenf = np.maximum(blen[:, 0].astype(f32), f32(1.0))
    r = np.fmod(p0, lenf)
    ph = np.where(wrap, np.where((r != 0) & ((r < 0) != (lenf < 0)), r + lenf, r), p0)
    ph_int = np.floor(np.maximum(ph, f32(0.0))).astype(np.int64)
    n_pool = -(-(int(base[-1]) + stride + (mix.window_rows(b) + 1) * 128) // 128) * 128
    pool = np.zeros(n_pool, f32)
    for k in range(s):
        pool[base[k]:base[k] + b] = samples[k]
    buf_off = np.zeros((s, nl), np.int32)
    buf_off[:, 0] = base - np.minimum(ph_int, np.maximum(blen[:, 0] - 1, 0))
    buf_off[:, 1:] = rng.integers(0, 50_000, (s, nl - 1))
    head = rng.uniform(0, 3000, (s, nl)).astype(f32)
    head[:, 0] = p0
    ed = rng.uniform(0.5, 2.4, (s, nl)).astype(f32)
    ed[:, 0] = 1.0
    mixf = np.zeros((s, nl), f32)
    mixf[:, 0] = 1.0
    swh = np.where(ep["stream_mode"], p0 + f32(b + 10), f32(0.0)).astype(f32)
    fetch = dict(pool=pool, buf_offset=buf_off, buf_len=blen, playhead=head, eff_delta=ed,
                 mix_factor=mixf, looping=ep["looping"], stream_mode=ep["stream_mode"],
                 stream_write_head=swh, active=ep["active"])
    kf = {k: spat[k] for k in KF_ARGS}
    return FetchScene(fetch=fetch, block=b, kf=kf, use_hrtf=use_hrtf,
                      epilogue={k: ep[k] for k in EPILOGUE_OWN})


def spatialise_fed(case: str, seed: int = 0) -> FetchScene:
    """``spatialise_scene(case)`` as KF takes it now: its samples fed by a
    fetch (``_fed``, integer heads) and its epilogue's own fields."""
    sc = spatialise_scene(case, seed)
    return _fed(sc.arrays["samples"], sc.epilogue, sc.arrays, sc.use_hrtf, True)


def epilogue_fed(case: str, seed: int = 0) -> FetchScene:
    """``epilogue_scene(case)`` as KF takes it now: its samples fed by a
    fetch whose new layer-0 heads are the case's, to the bit (heads at
    exactly buf_len - 1 and one ulp below stay so)."""
    sc = epilogue_scene(case, seed)
    return _fed(sc.spatialise["samples"], sc.epilogue, sc.spatialise, True, False)


FETCH_FIELDS = ("pool", "buf_offset", "buf_len", "playhead", "eff_delta", "mix_factor",
                "looping", "stream_mode", "stream_write_head", "active")
EPILOGUE_OWN = ("finished", "smoothed_level", "alive", "remove_on_finish")


def fetch_inputs(scene: FetchScene, device):
    """``audio_spatialise``'s arguments for ``scene`` on ``device``: the
    fetch tuple (``audio_fetch_plain``'s arguments: FETCH_FIELDS, the
    block and nw), KF's arguments, ``use_hrtf``, the epilogue tuple
    (EPILOGUE_OWN)."""
    from substrata_tpu_torch.audio import mix

    def t(x):
        return None if x is None else torch.as_tensor(x, device=device)
    fetch = tuple(t(scene.fetch[k]) for k in FETCH_FIELDS) + (
        scene.block, mix.window_rows(scene.block))
    return (fetch,) + tuple(t(scene.kf[k]) for k in KF_ARGS) + (
        scene.use_hrtf, tuple(t(scene.epilogue[k]) for k in EPILOGUE_OWN))
