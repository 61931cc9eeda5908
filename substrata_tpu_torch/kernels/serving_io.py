"""The serving tick's input apply (kernel KM) and its event digest and
transform block (kernel KN).

KM replaces ``substrata_tpu/physics/world.py:_apply_transforms_wake``
(:305-325): it reads the tick's packed host input — one float32 buffer
per tick, laid out below, the int32 slots bit-cast into it — and applies
up to 128 transform writes (position, rotation, and velocities where the
host provided them; each written body wakes with a zeroed sleep timer),
then wakes every alive dynamic body whose bound sphere (+0.3 m) meets one
of the 64 wake regions.  A padded region has radius -1e9, and the test
squares the radius sum, so a padded region meets every body: any tick
with a padded region wakes every dynamic body, in the reference as here.

KN replaces ``_digest_core`` (:258-275) and ``_tblock_core`` (:202-206):
the event digest the host reads every tick, as one int32 array —

  [0:64] newly-awake slots (-1 pad), [64:128] newly-asleep,
  [128:192] entered-water, [192:196] counts (awake, asleep, water,
  touching events), [196:200] num_pairs, broadphase_overflow,
  num_contacts, num_awake, [200:456] the first 128 touching pairs
  (a, b), [456] pair-cache steps_left, then the newly-awake,
  newly-asleep and entered-water masks bit-packed (bit j of word w =
  slot 32w + j), which the host reads only when a class overflows its
  64 slots —

and the [N, 14] float32 transform block (pos | quat | linvel | angvel |
underwater) that ``sync_transforms`` reads.

Each wrapper runs its plain twin for CPU tensors and launches
``csrc/serving_io.cu`` for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.pairs import _compact as compact

TIN_K = 128          # transform-write rows per tick
TIN_R = 64           # wake regions per tick
TIN_SCAL = 8         # dt, move (3), jump, fly, sitting, excluded slot
O_IDX = TIN_SCAL
O_POS = O_IDX + TIN_K
O_ROT = O_POS + 3 * TIN_K
O_LV = O_ROT + 4 * TIN_K
O_AV = O_LV + 3 * TIN_K
O_VOK = O_AV + 3 * TIN_K
O_CTR = O_VOK + TIN_K
O_RAD = O_CTR + 3 * TIN_R
TIN_TOTAL = O_RAD + TIN_R

EVK = 64             # digest slots per event class (wakes / sleeps / water)
EVT = 128            # touching-pair slots in the digest
DIGEST_HEAD = 200 + 2 * EVT + 1

launches = {"apply_tick_in": 0, "digest_tblock": 0}


def empty_tick_in(capacity: int) -> np.ndarray:
    """A tick input with no writes (every slot = capacity, dropped) and no
    wake regions (radius -1e9)."""
    buf = np.zeros(TIN_TOTAL, np.float32)
    buf[O_IDX:O_POS].view(np.int32)[:] = capacity
    buf[O_RAD:] = -1e9
    return buf


def pack_writes(buf: np.ndarray, items, regions):
    """Fill ``buf``'s write rows from ``items`` [(slot, ob, has_velocity)]
    (at most TIN_K, distinct slots) and its regions from ``regions``
    [(centre, radius)] (at most TIN_R)."""
    idx = buf[O_IDX:O_POS].view(np.int32)
    pos = buf[O_POS:O_ROT].reshape(TIN_K, 3)
    rot = buf[O_ROT:O_LV].reshape(TIN_K, 4)
    lv = buf[O_LV:O_AV].reshape(TIN_K, 3)
    av = buf[O_AV:O_VOK].reshape(TIN_K, 3)
    vok = buf[O_VOK:O_CTR]
    for j, (s, o, hv) in enumerate(items):
        idx[j] = s
        pos[j] = o.pos
        rot[j] = o.rot
        lv[j] = o.linvel
        av[j] = o.angvel
        vok[j] = 1.0 if hv else 0.0
    ctr = buf[O_CTR:O_RAD].reshape(TIN_R, 3)
    rad = buf[O_RAD:]
    for j, (c, r) in enumerate(regions):
        ctr[j] = c
        rad[j] = r


def digest_len(capacity: int) -> int:
    return DIGEST_HEAD + 3 * ((capacity + 31) // 32)


# --- KM ---------------------------------------------------------------------

STATE_IN = ("pos", "quat", "linvel", "angvel", "awake", "sleep_timer", "alive",
            "motion_type", "bound_radius")
STATE_OUT = ("pos", "quat", "linvel", "angvel", "awake", "sleep_timer")


def _scatter(x, idx, val):
    """x[idx] = val with out-of-range rows dropped (a trash row)."""
    n = x.shape[0]
    buf = torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                                    device=x.device)])
    buf[torch.where((idx >= 0) & (idx < n), idx, n)] = val
    return buf[:n]


def apply_tick_in_plain(state, tin):
    """Returns the new (pos, quat, linvel, angvel, awake, sleep_timer)."""
    n = state.pos.shape[0]
    idx = tin[O_IDX:O_POS].view(torch.int32).long()
    vok = tin[O_VOK:O_CTR] > 0
    vidx = torch.where(vok, idx, n)
    pos = _scatter(state.pos, idx, tin[O_POS:O_ROT].reshape(TIN_K, 3))
    quat = _scatter(state.quat, idx, tin[O_ROT:O_LV].reshape(TIN_K, 4))
    linvel = _scatter(state.linvel, vidx, tin[O_LV:O_AV].reshape(TIN_K, 3))
    angvel = _scatter(state.angvel, vidx, tin[O_AV:O_VOK].reshape(TIN_K, 3))
    awake = _scatter(state.awake, idx, True)
    sleep_timer = _scatter(state.sleep_timer, idx, 0.0)
    d = pos[:, None, :] - tin[O_CTR:O_RAD].reshape(TIN_R, 3)[None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    r = tin[O_RAD:][None] + state.bound_radius[:, None] + 0.3
    hit = torch.any(d2 <= r * r, dim=1) & state.alive & state.dynamic
    return (pos, quat, linvel, angvel, awake | hit,
            torch.where(hit, 0.0, sleep_timer))


def apply_tick_in(state, tin):
    """KM: the tick input applied to the body state (a new BodyState).
    ``apply_tick_in_plain`` for CPU tensors, ``csrc/serving_io.cu`` (one
    thread per body) for CUDA tensors."""
    if state.pos.device.type == "cpu":
        out = apply_tick_in_plain(state, tin)
    else:
        dev = state.pos.device
        n = state.capacity
        f32, i32, bl = torch.float32, torch.int32, torch.bool
        spec = dict(pos=(f32, (n, 3)), quat=(f32, (n, 4)), linvel=(f32, (n, 3)),
                    angvel=(f32, (n, 3)), awake=(bl, (n,)), sleep_timer=(f32, (n,)),
                    alive=(bl, (n,)), motion_type=(i32, (n,)), bound_radius=(f32, (n,)))
        for name in STATE_IN:
            build.check(getattr(state, name), name, *spec[name], dev)
        build.check(tin, "tick_in", f32, (TIN_TOTAL,), dev)
        out = tuple(torch.empty_like(getattr(state, f)) for f in STATE_OUT)
        build.launch("apply_tick_in", *(getattr(state, f) for f in STATE_IN), tin, n, *out)
        launches["apply_tick_in"] += 1
    return state.replace(**dict(zip(STATE_OUT, out)))


# --- KN ---------------------------------------------------------------------

def pack_bits(mask):
    """Bool [N] -> int32 words [ceil(N/32)], bit j of word w = mask[32w+j]."""
    n = mask.shape[0]
    words = (n + 31) // 32
    m = torch.zeros(words * 32, dtype=torch.int64, device=mask.device)
    m[:n] = mask.to(torch.int64)
    v = (m.reshape(words, 32) << torch.arange(32, device=mask.device)).sum(dim=1)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    bits = (words.astype(np.uint32)[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(-1)[:n].astype(bool)


def transform_block(state):
    """[N, 14] f32: pos | quat | linvel | angvel | underwater."""
    return torch.cat([state.pos, state.quat, state.linvel, state.angvel,
                      state.underwater.to(torch.float32)[:, None]], dim=1)


def digest_tblock_plain(events, num_contacts, num_awake, steps_left, state, with_block=True):
    """Returns (digest [digest_len(N)] i32, transform block [N, 14] or None
    without ``with_block``)."""
    up = compact(events.newly_awake, EVK)
    down = compact(events.newly_asleep, EVK)
    wet = compact(events.entered_water, EVK)
    touch = compact(events.contact_touching, EVT)
    tsafe = torch.clamp(touch, min=0)
    ta = torch.where(touch >= 0, events.contact_pair_a[tsafe].long(), -1)
    tb = torch.where(touch >= 0, events.contact_pair_b[tsafe].long(), -1)
    counts = torch.stack([
        events.newly_awake.sum(), events.newly_asleep.sum(), events.entered_water.sum(),
        events.contact_touching.sum(), events.num_pairs.long(),
        events.broadphase_overflow.long(), num_contacts.long(), num_awake.long()])
    head = torch.cat([up, down, wet, counts, torch.stack([ta, tb], dim=1).reshape(-1),
                      steps_left.long().reshape(1)])
    digest = torch.cat([head.to(torch.int32), pack_bits(events.newly_awake),
                        pack_bits(events.newly_asleep), pack_bits(events.entered_water)])
    return digest, transform_block(state) if with_block else None


def digest_tblock(events, num_contacts, num_awake, steps_left, state, out=None,
                  with_block=True):
    """KN: ``digest_tblock_plain`` for CPU tensors, ``csrc/serving_io.cu``
    (four compaction blocks and a grid for the bit words and the block, one
    launch) for CUDA tensors.  ``out``, when given, is the int32 tensor the
    digest goes to (a view into the tick's readback buffer).  Without
    ``with_block`` the transform block is not written (``think``: the
    reference packs it only when ``sync_transforms`` asks)."""
    if state.pos.device.type == "cpu":
        digest, block = digest_tblock_plain(events, num_contacts, num_awake, steps_left, state,
                                            with_block)
        if out is not None:
            out.copy_(digest)
            digest = out
        return digest, block
    dev = state.pos.device
    n, p = state.capacity, events.contact_touching.shape[0]
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    for t, name, dt, shp in (
            (events.newly_awake, "newly_awake", bl, (n,)),
            (events.newly_asleep, "newly_asleep", bl, (n,)),
            (events.entered_water, "entered_water", bl, (n,)),
            (events.contact_touching, "contact_touching", bl, (p,)),
            (events.contact_pair_a, "contact_pair_a", i32, (p,)),
            (events.contact_pair_b, "contact_pair_b", i32, (p,)),
            (events.num_pairs, "num_pairs", i32, ()),
            (events.broadphase_overflow, "broadphase_overflow", i32, ()),
            (num_contacts, "num_contacts", i32, ()), (num_awake, "num_awake", i32, ()),
            (steps_left, "steps_left", i32, ()),
            (state.pos, "pos", f32, (n, 3)), (state.quat, "quat", f32, (n, 4)),
            (state.linvel, "linvel", f32, (n, 3)), (state.angvel, "angvel", f32, (n, 3)),
            (state.underwater, "underwater", bl, (n,))):
        build.check(t, name, dt, shp, dev)
    if out is None:
        out = torch.empty(digest_len(n), dtype=i32, device=dev)
    build.check(out, "out", i32, (digest_len(n),), dev)
    block = torch.empty((n, 14), dtype=f32, device=dev) if with_block else None
    build.launch("digest_tblock", events.newly_awake, events.newly_asleep,
                 events.entered_water, events.contact_touching, events.contact_pair_a,
                 events.contact_pair_b, events.num_pairs, events.broadphase_overflow,
                 num_contacts, num_awake, steps_left, state.pos, state.quat, state.linvel,
                 state.angvel, state.underwater, n, p, out, block)
    launches["digest_tblock"] += 1
    return out, block
