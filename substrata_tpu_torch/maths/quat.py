"""Quaternion operations over trailing-dim-4 tensors, (x, y, z, w) layout.

Counterpart of ``substrata_tpu/maths/quat.py``.  Every function broadcasts
over leading batch axes, so the physics step works on [N, 4] orientations
directly.  Products are written out component by component (no matmul):
the hand-written kernels repeat the same operations in the same order, so
a kernel and its plain twin round alike.
"""

from __future__ import annotations

import torch


def identity(batch_shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def basis(batch_shape, k: int, device=None):
    """The unit vector e_k, [*batch_shape, 3], built on the device (no
    host -> device copy)."""
    e = torch.zeros(tuple(batch_shape) + (3,), dtype=torch.float32, device=device)
    e[..., k] = 1.0
    return e


def cross(a, b):
    """Cross product over the trailing axis, written out."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def dot3(a, b):
    """((a0*b0 + a1*b1) + a2*b2) over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def mul(a, b):
    """Hamilton product a*b (apply b's rotation, then a's)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def normalize(q, eps=1e-12):
    n2 = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
          + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3])
    return q / torch.sqrt(torch.clamp(n2, min=eps))[..., None]


def rotate_vec(q, v):
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4]."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def inverse_rotate_vec(q, v):
    return rotate_vec(conjugate(q), v)


def from_axis_angle(axis, angle):
    """axis [..., 3] (unit), angle [...] -> (axis sin(angle/2), cos(angle/2))."""
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def to_axis_angle(q):
    """(axis [..., 3], angle [...]) of a unit quaternion, angle in [0, pi];
    the axis is (1, 0, 0) where the rotation is the identity."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    sin_half = torch.sqrt(dot3(q[..., :3], q[..., :3]))
    angle = 2.0 * torch.atan2(sin_half, q[..., 3])
    safe = torch.clamp(sin_half, min=1e-12)[..., None]
    axis = torch.where(sin_half[..., None] < 1e-8, basis(q.shape[:-1], 0, q.device),
                       q[..., :3] / safe)
    return axis, angle


def to_matrix(q):
    """Rotation matrix [..., 3, 3] from a unit quaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def integrate(q, omega, dt):
    """First-order orientation update: normalize(q + 0.5*dt*(omega_quat*q))."""
    oq = torch.cat([omega, torch.zeros_like(q[..., :1])], dim=-1)
    dq = 0.5 * dt * mul(oq, q)
    return normalize(q + dq)
