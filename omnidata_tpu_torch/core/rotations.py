"""Rotation helpers in the reference's (Blender) conventions: right-handed
axes, a camera looks down its local ``-Z`` with ``+Y`` up. All functions
are batched over leading dimensions.
"""
from __future__ import annotations

import torch


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Norm of (...,3) vectors, keepdim: sqrt(x0² + x1² + x2²) summed left
    to right, so every device rounds alike."""
    return torch.sqrt(x[..., 0:1] * x[..., 0:1] + x[..., 1:2] * x[..., 1:2]
                      + x[..., 2:3] * x[..., 2:3])


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...,3,3) @ (...,3,3) as explicit float32 sums: no TF32 and the same
    summation order on every device."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _rot(a: torch.Tensor, rows) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    env = {"c": c, "s": s, "-s": -s, "o": o, "z": z}
    return torch.stack(
        [torch.stack([env[k] for k in row], -1) for row in rows], -2)


def rot_x(a: torch.Tensor) -> torch.Tensor:
    """Rotation about +X by angle ``a`` (radians). Batched over a's shape."""
    return _rot(a, (("o", "z", "z"), ("z", "c", "-s"), ("z", "s", "c")))


def rot_y(a: torch.Tensor) -> torch.Tensor:
    return _rot(a, (("c", "z", "s"), ("z", "o", "z"), ("-s", "z", "c")))


def rot_z(a: torch.Tensor) -> torch.Tensor:
    return _rot(a, (("c", "-s", "z"), ("s", "c", "z"), ("z", "z", "o")))


def _stack_rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(list(r), -1) for r in rows], -2)


def euler_xyz_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Blender 'XYZ' euler (...,3) -> R = Rz(z) @ Ry(y) @ Rx(x) (...,3,3)."""
    return _mm(rot_z(euler[..., 2]), _mm(rot_y(euler[..., 1]),
                                         rot_x(euler[..., 0])))


def matrix_to_euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> Blender 'XYZ' euler (...,3); x is 0 at
    gimbal lock (|cos y| <= 1e-6), as mathutils does."""
    y = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    safe = torch.abs(torch.cos(y)) > 1e-6
    x = torch.where(safe, torch.atan2(R[..., 2, 1], R[..., 2, 2]), 0.0)
    z = torch.where(safe, torch.atan2(R[..., 1, 0], R[..., 0, 0]),
                    torch.atan2(-R[..., 0, 1], R[..., 1, 1]))
    return torch.stack([x, y, z], -1)


def _qnorm(q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(q[..., 0:1] * q[..., 0:1] + q[..., 1:2] * q[..., 1:2]
                      + q[..., 2:3] * q[..., 2:3] + q[..., 3:4] * q[..., 3:4])


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (...,4) (w,x,y,z), normalised first -> (...,3,3)."""
    q = q / _qnorm(q)
    w, x, y, z = q.unbind(-1)
    return _stack_rows((
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion (w,x,y,z) with w >= 0:
    Shepperd's method, the candidate of the largest of (trace, m00, m11,
    m22) kept (the first on ties, as argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = _stack_rows((  # (...,4,4): one candidate quaternion per row
        (1.0 + tr, m21 - m12, m02 - m20, m10 - m01),
        (m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20),
        (m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21),
        (m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22),
    ))
    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)
    q = torch.gather(cands, -2,
                     best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / _qnorm(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of (w,x,y,z) quaternions; rotation a∘b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (...,3) by quaternion q (...,4)."""
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + q[..., :1] * t + _cross(qv, t)


def euler_xyz_to_quat(euler: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(euler_xyz_to_matrix(euler))


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_euler_xyz(quat_to_matrix(q))


def rotate_euler(euler: torch.Tensor, delta_euler: torch.Tensor) -> torch.Tensor:
    """Blender ``Euler.rotate``: the euler of R_delta @ R_euler."""
    return matrix_to_euler_xyz(
        _mm(euler_xyz_to_matrix(delta_euler), euler_xyz_to_matrix(euler)))


def rotate_axis_x(euler: torch.Tensor, angle: float) -> torch.Tensor:
    """Blender ``Euler.rotate_axis('X', angle)``: R_old @ Rx(angle)."""
    a = torch.as_tensor(angle, dtype=euler.dtype, device=euler.device)
    return matrix_to_euler_xyz(_mm(euler_xyz_to_matrix(euler), rot_x(a)))


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions (linear
    where they are within sin(theta) < 1e-6); t is a scalar or one value per
    leading index."""
    q0 = q0 / _qnorm(q0)
    q1 = q1 / _qnorm(q1)
    d = (q0[..., 0:1] * q1[..., 0:1] + q0[..., 1:2] * q1[..., 1:2]
         + q0[..., 2:3] * q1[..., 2:3] + q0[..., 3:4] * q1[..., 3:4])
    q1 = torch.where(d < 0, -q1, q1)
    theta = torch.acos(torch.clamp(torch.abs(d), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    safe = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / _qnorm(out)
