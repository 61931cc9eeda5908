"""Contact generation for the box world.

Counterpart of ``substrata_tpu/physics/narrowphase.py``, the part the box
world runs: the single-combo box-box branch of ``pair_contacts`` (kernel KA,
``kernels/box_box.py``) with the pair-blocked emission, and the
heightfield branch of ``static_contacts`` (kernel KB,
``kernels/static_contacts.py``).  ``compact_contacts`` serves a world with
no shape combo yet (an empty world).

Not in this slice (ROADMAP.md queue 1, slice 3): sphere and capsule
closed forms, convex hulls, mixed-shape bucketing and static trimeshes;
``pair_contacts`` raises NotImplementedError for them.

Contact convention: ``normal`` points from body B (or the static world)
toward body A; positive ``penetration`` = overlapping.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import box_box as _ka
from substrata_tpu_torch.kernels import static_contacts as _kb
from substrata_tpu_torch.kernels.box_box import (  # noqa: F401
    CONTACT_MARGIN, box_box as _box_box, combine_friction, combine_restitution,
    prune_speculative,
)
from substrata_tpu_torch.kernels.static_contacts import shape_sample_points  # noqa: F401
from substrata_tpu_torch.physics.state import (BodyState, ShapeType, SimConfig,
                                               StaticWorld, _Replace)


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


_NUM_CODES = 16
_SAME_TYPE_CODES = (0, 5, 10, 15)
_MIXED_FRACTION = 4
_MANIFOLD_WIDTH = [1, 1, 1, 1,
                   1, 4, 2, 4,
                   1, 2, 1, 2,
                   1, 4, 2, 4]
_BOX_BOX = int(ShapeType.BOX) * 4 + int(ShapeType.BOX)


def _active_codes(config: SimConfig):
    present = list(config.present_shape_types)
    return [c for c in range(_NUM_CODES) if present[c // 4] and present[c % 4]]


def blocked_manifold_width(config: SimConfig, capacity: int) -> int:
    """Manifold width of the pair-blocked contact layout, or 0 when the
    world must use the compacted layout (as the reference decides it)."""
    active = _active_codes(config)
    if not active:
        return 0
    wm = max(_MANIFOLD_WIDTH[c] for c in active)
    entries = 0
    for c in active:
        cap = (config.max_pairs if c in _SAME_TYPE_CODES
               else max(64, config.max_pairs // _MIXED_FRACTION))
        entries += min(cap, config.max_pairs)
    if entries * wm > 8 * config.max_pairs:
        return 0
    if max(capacity.bit_length(), 1) + max(entries.bit_length(), 1) + 1 > 32:
        return 0
    return wm


def pair_contacts(body: BodyState, pair_a, pair_b, pair_valid,
                  config: SimConfig, blocked_wm: int = 0):
    """Manifolds for the broadphase pair list.

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
    if active != [_BOX_BOX] or blocked_wm not in (0, _ka.WM):
        raise NotImplementedError(
            f"shape combos {active} are not ported yet: this slice runs "
            "box-only worlds (ROADMAP.md queue 1, slice 3: the other shapes)")
    (a, b, point, normal, pen, valid, fric, rest, key,
     touching) = _ka.box_box_rows(body.pos, body.quat, body.shape_params,
                                  body.friction, body.restitution,
                                  body.is_sensor, pair_a, pair_b, pair_valid)
    if not blocked_wm:
        # Compacted layout keeps raw ids on empty slots.
        a = torch.clamp(pair_a, min=0).repeat_interleave(_ka.WM)
    return (Contacts(a=a, b=b, point=point, normal=normal, penetration=pen,
                     valid=valid, friction=fric, restitution=rest, key=key),
            touching, torch.zeros((), dtype=torch.int32, device=dev))


def static_contacts(body: BodyState, world: StaticWorld, config: SimConfig) -> Contacts:
    """Ground contacts of every body's sample points, body-blocked [N*K]."""
    if world.n_tris:
        raise NotImplementedError(
            "static trimesh contacts are not ported yet (ROADMAP.md queue 1, "
            "slice 3: the other shapes)")
    k = min(config.static_contacts_per_body, 8)
    rows = _kb.static_contacts(body, world.heightfield, world.has_heightfield,
                               k, config.present_shape_types)
    return Contacts(*rows)


def compact_contacts(contacts: Contacts, max_active: int):
    """Stream-compact valid contacts (touching first) into a fixed buffer.
    Returns (Contacts of size max_active, overflow)."""
    dev = contacts.a.device
    valid = contacts.valid
    touching = valid & (contacts.penetration > 0.0)
    spec = valid & ~touching
    n_touch = touching.sum()
    idx_t = torch.cumsum(touching.long(), 0) - 1
    idx_s = n_touch + torch.cumsum(spec.long(), 0) - 1
    out_idx = torch.where(touching, idx_t, idx_s)
    keep = valid & (out_idx < max_active)
    dst = torch.where(keep, out_idx, max_active)

    def put(x, fill):
        buf = torch.full((max_active + 1,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=dev)
        buf.index_put_((dst,), x)
        return buf[:max_active]

    ia = put(contacts.a, -1)
    cvalid = ia >= 0
    return Contacts(
        a=torch.where(cvalid, ia, 0), b=torch.where(cvalid, put(contacts.b, -1), -1),
        point=put(contacts.point, 0.0), normal=put(contacts.normal, 0.0),
        penetration=put(contacts.penetration, 0.0), valid=cvalid,
        friction=put(contacts.friction, 0.0),
        restitution=put(contacts.restitution, 0.0),
        key=torch.where(cvalid, put(contacts.key, -1), 0),
    ), torch.clamp(n_touch - max_active, min=0)
