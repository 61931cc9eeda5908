"""The contact rows that the narrowphase kernels write (KA, KK, KO).

A rows kernel writes 10 outputs: ``narrowphase.Contacts``' 9 fields a
row (a, b, point, normal, penetration, valid, friction, restitution,
key) and a touching flag a pair slot.  ``contact_buffer`` lays a mixed
world's rows out in one allocation and ``bucket_views`` cuts one bucket's
10 outputs from it; ``outputs`` checks such views (or makes new tensors)
for a kernel that writes them, and ``copied`` writes a twin's rows into
them.
"""

from __future__ import annotations

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
