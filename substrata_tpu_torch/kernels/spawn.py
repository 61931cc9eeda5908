"""A flush of particle spawns scattered into the ring (kernel KY).

Replaces K13's ``substrata_tpu/physics/particles.py:_scatter_spawn``
(:139-156): the reference scatters each 256-row chunk of a flush with one
jitted call (13 ``.at[idx].set`` with the padding index dropped); the port
packs the whole flush into one [n, 16] float32 buffer (``ROW_FIELDS``; the
sprite type travels as its int32 bits), copies it to the device once and
scatters it with one launch.  Row r lands at ring slot (cursor + r) % cap;
when a flush is longer than the ring the later row of a slot wins, as the
reference's later chunk does.  The state's tensors are written in place.

``spawn_rows`` runs ``spawn_rows_plain`` for CPU tensors and the launch
of ``csrc/particles_spawn.cu`` for CUDA ones.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build

launches = 0

# Columns of a packed spawn row: name -> (first column, width).
ROW_FIELDS = {"pos": (0, 3), "vel": (3, 3), "area": (6, 1), "mass": (7, 1),
              "restitution": (8, 1), "width": (9, 1), "dwidth_dt": (10, 1),
              "opacity": (11, 1), "dopacity_dt": (12, 1), "theta": (13, 1),
              "sprite_type": (14, 1), "die_on_hit": (15, 1)}
ROW_FLOATS = 16
STATE_FIELDS = ("pos", "vel", "area", "mass", "restitution", "width", "dwidth_dt", "opacity",
                "dopacity_dt", "theta", "sprite_type", "die_on_hit", "alive")


def pack_rows(pending: list) -> np.ndarray:
    """The queued spawns (dicts keyed as ROW_FIELDS) as one [n, 16] float32
    host buffer, each value rounded to float32 as the reference's columns
    are."""
    n = len(pending)
    buf = np.zeros((n, ROW_FLOATS), np.float32)
    for name, (c, w) in ROW_FIELDS.items():
        if name == "sprite_type":
            col = np.array([p[name] for p in pending], np.int32).view(np.float32)
        elif name == "die_on_hit":
            col = np.array([bool(p[name]) for p in pending], np.float32)
        else:
            col = np.array([p[name] for p in pending], np.float32)
        buf[:, c:c + w] = col.reshape(n, w)
    return buf


def spawn_rows_plain(ps, rows: torch.Tensor, cursor: int):
    """The twin: ``rows`` [n, 16] into ``ps``'s ring from ``cursor``."""
    n, cap = rows.shape[0], ps.capacity
    r = torch.arange(n, device=rows.device)
    keep = r + cap >= n
    idx = (cursor + r[keep]) % cap
    rk = rows[keep]
    for name, (c, w) in ROW_FIELDS.items():
        cur = getattr(ps, name)
        val = rk[:, c:c + w].reshape((-1,) + tuple(cur.shape[1:]))
        if name == "sprite_type":
            val = val.contiguous().view(torch.int32)
        elif name == "die_on_hit":
            val = val != 0.0
        cur[idx] = val
    ps.alive[idx] = True
    return ps


def spawn_rows(ps, rows: torch.Tensor, cursor: int):
    """KY: scatter the flush ``rows`` [n, 16] into the ring at ``cursor``
    (in place; returns ``ps``)."""
    global launches
    if rows.device.type == "cpu":
        return spawn_rows_plain(ps, rows, cursor)
    dev = rows.device
    n, cap = rows.shape[0], ps.capacity
    build.check(rows, "rows", torch.float32, (n, ROW_FLOATS), dev)
    f32 = torch.float32
    for name in STATE_FIELDS:
        t = getattr(ps, name)
        dt = torch.int32 if name == "sprite_type" else (
            torch.bool if name in ("die_on_hit", "alive") else f32)
        build.check(t, name, dt, (cap, 3) if name in ("pos", "vel") else (cap,), dev)
    build.launch("spawn_rows", *[getattr(ps, k) for k in STATE_FIELDS], rows, int(cursor),
                 n, cap)
    launches += 1
    return ps
