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
``csrc/serving_io.cu`` for CUDA tensors.  KM is one launch over tiles of
64 bodies, its outputs views of one buffer.  KN is one launch over tiles of
256 slots; its last block selects the first slots from the tiles' counts
and bit words, which a plan per (N, P, device) keeps in a scratch buffer
with the launch's ticket (zeroed once: the kernel resets it).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.pairs import _compact as compact
from substrata_tpu_torch.maths.fp import dot3

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
    """x[idx] = val as the reference's ``.at[idx].set(val, mode="drop")``:
    a negative slot counts from the end (-1 is slot N - 1), and a slot
    still outside [0, N) is dropped (a trash row)."""
    n = x.shape[0]
    buf = torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                                    device=x.device)])
    idx = torch.where(idx < 0, idx + n, idx)
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
    # The squared distance as the jitted reference contracts its sum:
    # fma(d2, d2, fma(d1, d1, d0 * d0)).
    d = pos[:, None, :] - tin[O_CTR:O_RAD].reshape(TIN_R, 3)[None]
    d2 = dot3(d, d)
    r = tin[O_RAD:][None] + state.bound_radius[:, None] + 0.3
    hit = torch.any(d2 <= r * r, dim=1) & state.alive & state.dynamic
    return (pos, quat, linvel, angvel, awake | hit,
            torch.where(hit, 0.0, sleep_timer))


_TICK_PACK = struct.Struct("=12q")     # csrc/serving_io.cu:apply_tick_in
_tick_plans: dict = {}


class _TickPlan:
    """KM's checks and output layout for one (N, device): the inputs'
    dtypes and shapes, and the one float32 buffer a call writes, [pos 3N |
    quat 4N | linvel 3N | angvel 3N | sleep_timer N | awake N bytes]."""

    def __init__(self, n, device):
        f32, i32, bl = torch.float32, torch.int32, torch.bool
        self.device = device
        self.dtypes = (f32, f32, f32, f32, bl, f32, bl, i32, f32, f32)
        self.shapes = ((n, 3), (n, 4), (n, 3), (n, 3), (n,), (n,), (n,), (n,), (n,),
                       (TIN_TOTAL,))
        self.size = 14 * n + (n + 3) // 4
        self.n = n


def tick_views(buf: torch.Tensor, n: int):
    """KM's outputs as views of its buffer, in ``STATE_OUT``'s order (one
    ``as_strided`` a field: a quarter of the host time of slicing, then
    viewing)."""
    a = buf.as_strided
    return (a((n, 3), (3, 1), 0), a((n, 4), (4, 1), 3 * n), a((n, 3), (3, 1), 7 * n),
            a((n, 3), (3, 1), 10 * n), buf.view(torch.bool).as_strided((n,), (1,), 56 * n),
            a((n,), (1,), 13 * n))


def apply_tick_in(state, tin):
    """KM: the tick input applied to the body state (a new BodyState).
    ``apply_tick_in_plain`` for CPU tensors; for CUDA tensors one launch of
    ``csrc/serving_io.cu`` from one packed argument, checked once per (N,
    device), its six outputs views of one new buffer (the caller keeps the
    old state)."""
    if state.pos.device.type == "cpu":
        return state.replace(**dict(zip(STATE_OUT, apply_tick_in_plain(state, tin))))
    n = state.capacity
    plan = build.plan(_tick_plans, (n, state.pos.device), lambda: _TickPlan(n, state.pos.device))
    ins = tuple(getattr(state, f) for f in STATE_IN) + (tin,)
    build.check_all(plan.device, ins, STATE_IN + ("tick_in",), plan.dtypes, plan.shapes)
    buf = torch.empty(plan.size, dtype=torch.float32, device=plan.device)
    build.launch_packed("apply_tick_in",
                        _TICK_PACK.pack(*(t.data_ptr() for t in ins), buf.data_ptr(), n))
    launches["apply_tick_in"] += 1
    return state.replace(**dict(zip(STATE_OUT, tick_views(buf, n))))


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


_DIGEST_PACK = struct.Struct("=21q")    # csrc/serving_io.cu:digest_tblock
DIGEST_TILE = 256                         # slots a block of KN takes
_digest_plans: dict = {}


class _DigestPlan:
    """KN's checks and scratch for one (N, P, device): the inputs' dtypes
    and shapes, and an int32 buffer [ticket | the tiles' four counts |
    the touching mask's bit words] that every launch of this shape uses,
    so those launches run in stream order (the port launches on one
    stream)."""

    NAMES = ("newly_awake", "newly_asleep", "entered_water", "contact_touching",
             "contact_pair_a", "contact_pair_b", "num_pairs", "broadphase_overflow",
             "num_contacts", "num_awake", "steps_left", "pos", "quat", "linvel", "angvel",
             "underwater")

    def __init__(self, n, p, device):
        f32, i32, bl = torch.float32, torch.int32, torch.bool
        self.device = device
        self.dtypes = (bl,) * 4 + (i32,) * 7 + (f32,) * 4 + (bl,)
        self.shapes = ((n,),) * 3 + ((p,),) * 3 + ((),) * 5 + ((n, 3), (n, 4), (n, 3), (n, 3),
                                                                 (n,))
        self.tiles = max(1, -(-max(n, p) // DIGEST_TILE))
        self.scratch = torch.zeros(1 + 4 * self.tiles + (p + 31) // 32, dtype=torch.int32,
                                   device=device)
        self.sizes = (n, p)


def digest_tblock(events, num_contacts, num_awake, steps_left, state, out=None,
                  with_block=True):
    """KN: ``digest_tblock_plain`` for CPU tensors, ``csrc/serving_io.cu``
    (one launch over tiles of the masks and the block, checked once per
    (N, P) and launched from one packed argument) for CUDA tensors.
    ``out``, when given, is the int32 tensor the digest goes to (a view
    into the tick's readback buffer).  Without
    ``with_block`` the transform block is not written (``think``: the
    reference packs it only when ``sync_transforms`` asks)."""
    if state.pos.device.type == "cpu":
        digest, block = digest_tblock_plain(events, num_contacts, num_awake, steps_left, state,
                                            with_block)
        if out is not None:
            out.copy_(digest)
            digest = out
        return digest, block
    n, p = state.capacity, events.contact_touching.shape[0]
    dev = state.pos.device
    plan = build.plan(_digest_plans, (n, p, dev), lambda: _DigestPlan(n, p, dev))
    ins = (events.newly_awake, events.newly_asleep, events.entered_water,
           events.contact_touching, events.contact_pair_a, events.contact_pair_b,
           events.num_pairs, events.broadphase_overflow, num_contacts, num_awake, steps_left,
           state.pos, state.quat, state.linvel, state.angvel, state.underwater)
    build.check_all(plan.device, ins, plan.NAMES, plan.dtypes, plan.shapes)
    if out is None:
        out = torch.empty(digest_len(n), dtype=torch.int32, device=plan.device)
    else:
        build.check(out, "out", torch.int32, (digest_len(n),), plan.device)
    block = torch.empty((n, 14), dtype=torch.float32, device=plan.device) if with_block else None
    build.launch_packed("digest_tblock", _DIGEST_PACK.pack(
        *(t.data_ptr() for t in ins), out.data_ptr(), 0 if block is None else block.data_ptr(),
        plan.scratch.data_ptr(), *plan.sizes))
    launches["digest_tblock"] += 1
    return out, block
