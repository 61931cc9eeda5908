"""TRS transforms and inertia helpers.

Counterpart of ``substrata_tpu/maths/transform.py``:
ob_to_world = T(pos) * R(quat) * S(scale).
"""

from __future__ import annotations

import math

import torch

from substrata_tpu_torch.maths import quat as quatm


def trs_matrix(pos, q, scale):
    """[..., 4, 4] object-to-world from pos [..., 3], quat [..., 4], scale [..., 3]."""
    r = quatm.to_matrix(q) * scale[..., None, :]
    m = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    m[..., :3, :3] = r
    m[..., :3, 3] = pos
    m[..., 3, 3] = 1.0
    return m


def world_inv_inertia(q, inv_inertia_local_diag):
    """World-space inverse inertia R diag(I^-1) R^T, [..., 3, 3].

    Written out per entry (sum over k in order 0, 1, 2) so the kernels that
    repeat it round alike."""
    r = quatm.to_matrix(q)
    d = inv_inertia_local_diag
    rows = []
    for i in range(3):
        for j in range(3):
            rows.append(r[..., i, 0] * d[..., 0] * r[..., j, 0]
                        + r[..., i, 1] * d[..., 1] * r[..., j, 1]
                        + r[..., i, 2] * d[..., 2] * r[..., j, 2])
    m = torch.stack(rows, dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_vec(m, v):
    """m [..., 3, 3] @ v [..., 3], written out."""
    return torch.stack([m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
                        + m[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def box_inertia(half_extents, mass):
    """Diagonal local inertia of a solid box; he: [..., 3]."""
    hx, hy, hz = half_extents[..., 0], half_extents[..., 1], half_extents[..., 2]
    c = mass / 3.0
    return torch.stack([c * (hy * hy + hz * hz),
                        c * (hx * hx + hz * hz),
                        c * (hx * hx + hy * hy)], dim=-1)


def sphere_inertia(radius, mass):
    i = 0.4 * mass * radius * radius
    return torch.stack([i, i, i], dim=-1)


def capsule_inertia(radius, half_height, mass):
    """Solid capsule along local Z: a cylinder of half-height h + two caps."""
    r, h = radius, half_height
    vol_cyl = math.pi * r * r * (2 * h)
    vol_sph = (4.0 / 3.0) * math.pi * r ** 3
    vol = vol_cyl + vol_sph
    m_cyl = mass * vol_cyl / vol
    m_sph = mass * vol_sph / vol
    iz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
    ixy_cyl = m_cyl * ((1.0 / 12.0) * (2 * h) ** 2 + 0.25 * r * r)
    d = h + 3.0 * r / 8.0
    ixy_sph = 0.4 * m_sph * r * r + m_sph * d * d
    ixy = ixy_cyl + ixy_sph
    return torch.stack([ixy, ixy, iz], dim=-1)
