"""Hard inputs for the two stable counting sorts (KP's cell table and KT's
grouping), for KH's ray trace and for KL's character update.

For the sorts, these are the inputs where a bucket or a code's slice
fills, so the order of ties decides who is dropped, and where nothing is
live.  For the rays: more than k candidates tied at a zero entry key, a
body met twice through a bucket-hash collision, rays whose every candidate
row is empty, single-step marches, a trimesh whose cells hold fewer than 8
triangles.  For the character: scenes whose chosen update lands the stair
walk at the first, a late and the last of its 9 depths and at none, takes
the forward test column, and sticks to the floor at each of its 3
offsets, with 3 gather centres (1.4 m cells) and 2 (4 m), and a trimesh
step.  The CPU tests hold the twins against the reference on them at a
small size; ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the
kernels against the twins on them.  Everything is numpy, made from a seed;
slot order is shuffled so that index order is not space order.
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

# The ridge profile of ``land_last``'s heightfield: (x index, height), the
# walked part kept (x index < 33).
_RIDGES = ((2, 0.039344701915979385), (3, 0.011084635742008686), (14, 0.14859193563461304),
           (17, 0.053556617349386215), (20, 0.03770779073238373), (27, 0.0446929968893528),
           (30, 0.03628566116094589), (31, 0.04275369271636009), (36, 0.1971970796585083),
           (37, 0.15770938992500305), (43, 0.12775085866451263), (47, 0.1161520928144455),
           (48, 0.10643057525157928), (50, 0.19506436586380005), (62, 0.004727865103632212),
           (63, 0.00447685644030571))


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
