"""The contact rows that the narrowphase kernels write (KA, KK, KO).

A rows kernel writes 10 outputs: ``narrowphase.Contacts``' 9 fields a
row (a, b, point, normal, penetration, valid, friction, restitution,
key) and a touching flag a pair slot.  ``contact_buffer`` lays a mixed
world's rows out in one allocation and ``bucket_views`` cuts one bucket's
10 outputs from it; ``outputs`` checks such views (or makes new tensors)
for a kernel that writes them, and ``copied`` writes a twin's rows into
them.  ``placed`` and ``BucketPlan`` are what KK's and KO's one launch
over a step's buckets share: where each bucket's rows go, and the bucket
table packed into the launch's parameters.
"""

from __future__ import annotations

import struct
from itertools import accumulate

import torch

from substrata_tpu_torch.kernels import build

NAMES = ("a", "b", "point", "normal", "penetration", "valid", "friction", "restitution", "key",
         "touching")
_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool
DTYPES = (_I32, _I32, _F32, _F32, _F32, _BOOL, _F32, _F32, _I32, _BOOL)


def _shapes(rows: int, slots: int):
    return ((rows,), (rows,), (rows, 3), (rows, 3), (rows,), (rows,), (rows,), (rows,),
            (rows,), (slots,))


def contact_buffer(rows: int, slots: int, device):
    """One allocation holding the 9 contact fields of ``rows`` rows and
    ``slots`` touching flags, as views: (fields, touching).  Its bytes: the
    int32 a, b and key, the float32 point, normal, penetration, friction
    and restitution, then the bool valid and touching."""
    r = rows
    buf = torch.empty(49 * r + slots, dtype=torch.uint8, device=device)
    ints = buf[:12 * r].view(_I32)
    floats = buf[12 * r:48 * r].view(_F32)
    return ((ints[:r], ints[r:2 * r], floats[:3 * r].view(r, 3), floats[3 * r:6 * r].view(r, 3),
             floats[6 * r:7 * r], buf[48 * r:49 * r].view(_BOOL), floats[7 * r:8 * r],
             floats[8 * r:], ints[2 * r:]), buf[49 * r:].view(_BOOL))


def bucket_views(fields, touch, row0: int, rows: int, slot0: int, slots: int):
    """One bucket's 10 outputs as views of ``contact_buffer``'s fields."""
    return tuple(f[row0:row0 + rows] for f in fields) + (touch[slot0:slot0 + slots],)


def outputs(out, rows: int, slots: int, device):
    """A rows kernel's 10 outputs for ``rows`` rows and ``slots`` pair
    slots: ``out`` checked, or new tensors where it is None."""
    shapes = _shapes(rows, slots)
    if out is None:
        return tuple(torch.empty(s, dtype=d, device=device) for s, d in zip(shapes, DTYPES))
    build.check_all(device, out, NAMES, DTYPES, shapes)
    return tuple(out)


def copied(rows, out):
    """A twin's 10 outputs, or, where ``out`` is given, copied into it."""
    if out is None:
        return rows
    for dst, src in zip(out, rows):
        dst.copy_(src)
    return out


# A bucket's record in a launch's bucket table (csrc/closed_forms.cu and
# csrc/convex.cu:Bucket): the offsets of its slots, rows and touching flags,
# its code, width, first block and slots.
BUCKET = struct.Struct("=3q4i")
NO_BLOCK = 0x7FFFFFFF   # a table entry past every block


class BucketPlan:
    """One layout of a bucketed rows kernel's buckets: the bucket table
    (``host_table``: a row a bucket of code, width, first block, slots, and
    the offsets of its slots in the first bucket's ba, bb and bvalid, of
    its rows and of its touching flags in the outputs; ``table``: the
    launch's packed copy, each bucket's first block, then each bucket's
    record, both padded to ``max_buckets``) and the grid, ``blocks_of(slots)``
    blocks a bucket, aligned to buckets."""

    def __init__(self, codes, caps, wms, offs, rows_at, touch_at, max_buckets, blocks_of):
        first = list(accumulate((blocks_of(c) for c in caps), initial=0))
        self.blocks = first[-1]
        self.host_table = [[code, wm, b0, cap, off, r0, t0] for code, wm, b0, cap, off, r0, t0
                           in zip(codes, wms, first, caps, offs, rows_at, touch_at)]
        pad = max_buckets - len(codes)
        self.table = (struct.pack(f"={max_buckets}i", *first[:-1], *[NO_BLOCK] * pad)
                      + b"".join(BUCKET.pack(off, r0, t0, code, wm, b0, cap)
                                 for code, wm, b0, cap, off, r0, t0 in self.host_table)
                      + bytes(BUCKET.size * pad))


def placed(out, caps, wms, device):
    """Where a call over buckets of ``caps`` slots and ``wms`` rows a slot
    writes: (fields, touching, rows_at, touch_at).  ``out`` is that tuple,
    checked here; where it is None, a ``contact_buffer`` of the call's own
    holds the buckets one after another."""
    if out is None:
        rows_at = tuple(accumulate((c * w for c, w in zip(caps, wms)), initial=0))
        touch_at = tuple(accumulate(caps, initial=0))
        fields, touch = contact_buffer(rows_at[-1], touch_at[-1], device)
        rows_at, touch_at = rows_at[:-1], touch_at[:-1]
    else:
        fields, touch, rows_at, touch_at = out
        rows_at, touch_at = tuple(rows_at), tuple(touch_at)
        r, t = fields[0].shape[0], touch.shape[0]
        outputs(tuple(fields) + (touch,), r, t, device)
        if any(r0 + c * w > r or t0 + c > t
               for r0, t0, c, w in zip(rows_at, touch_at, caps, wms)):
            raise ValueError(f"out: {r} rows and {t} flags, too few for the buckets")
    return fields, touch, rows_at, touch_at


def placed_views(fields, touch, rows_at, touch_at, caps, wms):
    """Each bucket's 10 outputs as views of ``placed``'s fields."""
    return [bucket_views(fields, touch, r0, c * w, t0, c)
            for r0, t0, c, w in zip(rows_at, touch_at, caps, wms)]
