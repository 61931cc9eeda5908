"""Contact generation.

Counterpart of ``substrata_tpu/physics/narrowphase.py``: ``pair_contacts``
with the box-box manifold (kernel KA, ``kernels/box_box.py``), the
sphere/box/capsule closed forms (kernel KK, ``kernels/closed_forms.py``)
and the generic convex SAT of the hull combos (kernel KO,
``kernels/convex.py``), bucketed by combo code in mixed worlds (kernel
KT's grouping, ``kernels/layout.py``), in the pair-blocked or the
compacted layout; ``static_contacts`` against the heightfield and the
static trimesh (kernel KB, ``kernels/static_contacts.py``);
``compact_contacts`` (kernel KT).

Contact convention: ``normal`` points from body B (or the static world)
toward body A; positive ``penetration`` = overlapping.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import box_box as _ka
from substrata_tpu_torch.kernels import closed_forms as _kk
from substrata_tpu_torch.kernels import convex as _ko
from substrata_tpu_torch.kernels import layout as _kt
from substrata_tpu_torch.kernels import static_contacts as _kb
from substrata_tpu_torch.kernels.box_box import (  # noqa: F401
    CONTACT_MARGIN, box_box as _box_box, combine_friction, combine_restitution,
    prune_speculative,
)
from substrata_tpu_torch.kernels.static_contacts import shape_sample_points  # noqa: F401
from substrata_tpu_torch.physics.state import (BodyState, HullLibrary, ShapeType, SimConfig,
                                               StaticWorld, _Replace, empty_hull_library)


@dataclasses.dataclass
class Contacts(_Replace):
    """Flat padded contact batch."""

    a: torch.Tensor            # [C] i32 body slot (-1 = empty pair entry)
    b: torch.Tensor            # [C] i32 body slot, -1 = static world
    point: torch.Tensor        # [C, 3] world position
    normal: torch.Tensor       # [C, 3] from b to a
    penetration: torch.Tensor  # [C]
    valid: torch.Tensor        # [C] bool
    friction: torch.Tensor     # [C] combined
    restitution: torch.Tensor  # [C] combined
    # Warm-start identity (a, key): key = sample_slot+1 (1..8) for static
    # contacts, b*4 + manifold_slot + 9 for body pairs, 0 = none.
    key: torch.Tensor          # [C] i32

    @property
    def capacity(self):
        return self.a.shape[0]


CONTACT_FIELDS = tuple(f.name for f in dataclasses.fields(Contacts))


_MANIFOLD_WIDTH = [1, 1, 1, 1,
                   1, 4, 2, 4,
                   1, 2, 1, 2,
                   1, 4, 2, 4]
_BOX_BOX = int(ShapeType.BOX) * 4 + int(ShapeType.BOX)


def _active_codes(config: SimConfig):
    present = list(config.present_shape_types)
    return [c for c in range(_kt.NUM_CODES) if present[c // 4] and present[c % 4]]


def blocked_manifold_width(config: SimConfig, capacity: int) -> int:
    """Manifold width of the pair-blocked contact layout, or 0 when the
    world must use the compacted layout (as the reference decides it)."""
    active = _active_codes(config)
    if not active:
        return 0
    wm = max(_MANIFOLD_WIDTH[c] for c in active)
    entries = 0
    for c in active:
        entries += _kt.bucket_cap(c, config.max_pairs, config.max_pairs)
    if entries * wm > 8 * config.max_pairs:
        return 0
    if max(capacity.bit_length(), 1) + max(entries.bit_length(), 1) + 1 > 32:
        return 0
    return wm


def _bucket_rows(code: int, wm: int, blocked: bool, body: BodyState, ba, bb, bvalid, hulls):
    """One bucket's rows through KA (box-box), KK (the closed forms) or KO
    (the hull codes)."""
    if code == _BOX_BOX:
        rows = _ka.box_box_rows(body.pos, body.quat, body.shape_params, body.friction,
                                body.restitution, body.is_sensor, ba, bb, bvalid)
        if not blocked:
            # Compacted layout keeps raw ids on empty slots.
            rows = (ba.repeat_interleave(_ka.WM),) + tuple(rows[1:])
        return rows
    if code in _ko.CODES:
        return _ko.convex_rows(code, wm, blocked, body.pos, body.quat, body.shape_params,
                               body.friction, body.restitution, body.is_sensor, ba, bb, bvalid,
                               hulls)
    return _kk.closed_form_rows(code, wm, blocked, body.pos, body.quat, body.shape_params,
                                body.friction, body.restitution, body.is_sensor, ba, bb,
                                bvalid)


def buckets(body: BodyState, pair_a, pair_b, pair_valid, config: SimConfig):
    """The pair list grouped by combo code (narrowphase.py:663-720; kernel
    KT's grouping in a mixed world).

    Returns ([(code, src, ba, bb, bvalid)] for each present code, overflow
    [] i32, slot_of_pair): ``src`` is each bucket slot's pair index (-1
    empty; None in a single-combo world, where the bucket is the pair list
    in place), ``ba`` and ``bb`` the slots' bodies, ``bvalid`` their
    occupancy; ``slot_of_pair`` (the card only) each pair's slot in the
    concatenated buckets."""
    active = _active_codes(config)
    if len(active) == 1:
        a = torch.clamp(pair_a, min=0)
        b = torch.clamp(pair_b, min=0)
        return ([(active[0], None, a, b, pair_valid)],
                torch.zeros((), dtype=torch.int32, device=body.device), None)
    return _kt.group(body.shape_type, pair_a, pair_b, pair_valid, active, config.max_pairs)


def pair_contacts(body: BodyState, pair_a, pair_b, pair_valid,
                  config: SimConfig, hulls: HullLibrary | None = None, blocked_wm: int = 0):
    """Manifolds for the broadphase pair list.

    A world with one shape combo runs its kernel on the pair list in
    place; a mixed world groups the pairs by combo code with one stable
    sort and runs each present code's kernel on its bucket, a slice of the
    sorted order (``max_pairs`` slots for same-type codes, ``max(64,
    max_pairs // 4)`` for the others; a run longer than its bucket counts
    as overflow).  ``hulls`` (the static world's library) feeds the hull
    codes; None stands for a one-row empty library, as in the reference.
    Nothing reads back to the host.

    Returns (Contacts, pair_touching [P], bucket overflow [])."""
    p = pair_a.shape[0]
    dev = body.device
    active = _active_codes(config)
    if not active:
        z3 = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        n3 = z3.clone()
        n3[:, 2] = 1.0
        zi = torch.full((1,), -1, dtype=torch.int32, device=dev)
        return (Contacts(a=zi, b=zi.clone(), point=z3, normal=n3,
                         penetration=torch.full((1,), -1e9, device=dev),
                         valid=torch.zeros((1,), dtype=torch.bool, device=dev),
                         friction=torch.zeros((1,), device=dev),
                         restitution=torch.zeros((1,), device=dev),
                         key=torch.zeros((1,), dtype=torch.int32, device=dev)),
                torch.zeros((p,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    if hulls is None:
        hulls = empty_hull_library(capacity=1, device=dev)
    bucket_list, overflow, slot_of_pair = buckets(body, pair_a, pair_b, pair_valid, config)
    batches, srcs, touches = [], [], []
    for code, src, ba, bb, bvalid in bucket_list:
        rows = _bucket_rows(code, blocked_wm or _MANIFOLD_WIDTH[code], bool(blocked_wm), body,
                            ba, bb, bvalid, hulls)
        batches.append(rows[:9])
        srcs.append(src)
        touches.append(rows[9])
    if len(active) == 1:
        return Contacts(*batches[0]), touches[0] & pair_valid, overflow
    contacts = Contacts(*(torch.cat([bt[i] for bt in batches]) for i in range(9)))
    # Per-pair touching for contact events: each bucket's flags to its pairs.
    return contacts, _kt.touching(srcs, touches, p, slot_of_pair), overflow


def static_contacts(body: BodyState, world: StaticWorld, config: SimConfig) -> Contacts:
    """Static contacts (heightfield and trimesh) of every body's sample
    points, body-blocked [N*K].  The hull samples come from the world's
    hull library; the reference's ``hull_contact_verts`` argument (step.py:
    132) is never read there, so the port does not take it."""
    k = min(config.static_contacts_per_body, 8)
    rows = _kb.static_contacts(body, world.heightfield, world.has_heightfield,
                               k, config.present_shape_types, world.hulls, world.trimesh,
                               config.max_tri_candidates)
    return Contacts(*rows)


def compact_contacts(contacts: Contacts, max_active: int):
    """Stream-compact valid contacts (touching first) into a fixed buffer
    (kernel KT).  Returns (Contacts of size max_active, overflow [] i32)."""
    rows, overflow = _kt.compact(tuple(getattr(contacts, f) for f in CONTACT_FIELDS),
                                 max_active)
    return Contacts(*rows), overflow
