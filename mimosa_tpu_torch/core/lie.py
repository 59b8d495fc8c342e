"""SO(3) / SE(3) / S^2 manifold operations on torch tensors, batch-first.

Port of ``mimosa_tpu/core/lie.py`` with the same conventions:

  * quaternions are Hamilton, scalar-first ``[w, x, y, z]``, unit norm;
  * ``exp``/``log`` use the right tangent convention;
  * every function broadcasts over leading batch dims and keeps the input
    dtype and device;
  * near-zero angles take Taylor branches, so the functions are safe under
    ``torch.func.jacfwd`` / ``vmap``.

S^2 (the gravity direction) follows GTSAM's Unit3: a 2-dof tangent basis
``B(g)`` with retraction ``g' = Exp(g x (B delta)) g``.
"""

from __future__ import annotations

import torch

_EPS2 = 1e-12  # squared-angle cutoff for Taylor branches


def cross(a, b):
    """Batched 3-vector cross product (broadcasting, vmap-safe)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _unit_x_or_y(g):
    """[1, 0, 0], or [0, 1, 0] where |g_x| > 0.9 — the reference axis least
    aligned with g. Built from g by elementwise ops: a constant made with
    ``torch.tensor(..., device=cuda)`` would cost a blocking copy."""
    c = torch.abs(g[..., 0:1]) > 0.9
    one = torch.ones_like(g[..., 0:1])
    zero = torch.zeros_like(one)
    return torch.cat([torch.where(c, zero, one), torch.where(c, one, zero),
                      zero], dim=-1)


# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None):
    """[1, 0, 0, 0], made on the device by a kernel (the first row of a
    1x4 identity): ``torch.tensor(..., device=cuda)`` would be a blocking
    copy from pageable memory, which a captured step cannot hold."""
    return torch.eye(1, 4, dtype=dtype, device=device)[0]


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product q1 ⊗ q2 (batched)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """Rotation matrix -> quaternion (Shepperd's method, branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30)) / 2.0

    qw0 = half_sqrt(1.0 + tr)
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    q = torch.where((tr > 0.0)[..., None], c0, torch.where(
        ((m00 > m11) & (m00 > m22))[..., None], c1,
        torch.where((m11 > m22)[..., None], c2, c3)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) exp / log / hat / Jacobians
# ---------------------------------------------------------------------------

def hat(v):
    """so(3) hat operator, batched: v in R^3 -> 3x3 skew matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def exp_so3(phi):
    """Axis-angle -> quaternion, Taylor-safe near zero."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-30)
    half = 0.5 * theta
    small = theta2 < _EPS2
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def exp_so3_mat(phi):
    """Axis-angle -> rotation matrix (Rodrigues), Taylor-safe."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-30)
    K = hat(phi)
    small = theta2 < _EPS2
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * K + b * (K @ K)


def log_so3(q):
    """Quaternion -> axis-angle in (-pi, pi], Taylor-safe near identity."""
    q = torch.where(q[..., :1] < 0, -q, q)  # principal log: w >= 0
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    vn = torch.sqrt(vn2 + 1e-30)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < _EPS2
    k = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / vn)
    return k * q[..., 1:]


def left_jacobian_so3(phi):
    """SO(3) left Jacobian J_l(phi)."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-30)
    K = hat(phi)
    small = theta2 < _EPS2
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + b * K + c * (K @ K)


def right_jacobian_so3(phi):
    """SO(3) right Jacobian J_r(phi) = J_l(-phi)."""
    return left_jacobian_so3(-phi)


def inv_right_jacobian_so3(phi):
    """Inverse right Jacobian, Taylor-safe."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-30)
    K = hat(phi)
    small = theta2 < _EPS2
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / theta2 - (1.0 + torch.cos(theta))
        / (2.0 * theta * torch.sin(theta) + 1e-30))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + 0.5 * K + cot_term * (K @ K)


# ---------------------------------------------------------------------------
# SE(3) as (quaternion, translation)
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device=None):
    return (quat_identity(dtype, device),
            torch.zeros(3, dtype=dtype, device=device))


def se3_compose(qa, ta, qb, tb):
    """T_a * T_b."""
    return quat_mul(qa, qb), ta + quat_rotate(qa, tb)


def se3_inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_transform(q, t, p):
    """Apply T = (q, t) to point(s) p."""
    return quat_rotate(q, p) + t


def se3_retract(q, t, xi):
    """Right retraction with decoupled tangent ``xi = [dR(3), dt(3)]``:
    q' = q ⊗ Exp(dR), t' = t + R(q) dt."""
    dq = exp_so3(xi[..., :3])
    return quat_mul(q, dq), t + quat_rotate(q, xi[..., 3:6])


def se3_local(qa, ta, qb, tb):
    """Inverse of se3_retract: tangent taking (qa, ta) to (qb, tb)."""
    dq = quat_mul(quat_conj(qa), qb)
    dr = log_so3(dq)
    dt = quat_rotate(quat_conj(qa), tb - ta)
    return torch.cat([dr, dt], dim=-1)


def pose_tangent_adjoint(q_ab, t_ab):
    """[6,6] map A with xi_B = A @ xi_A for T_W_B = T_W_A @ T_AB:
    A = [[R_ab^T, 0], [-R_ab^T [t_ab]x, R_ab^T]]."""
    Rt = quat_to_mat(q_ab).transpose(-1, -2)
    z = torch.zeros_like(Rt)
    top = torch.cat([Rt, z], dim=-1)
    bottom = torch.cat([-Rt @ hat(t_ab), Rt], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def navstate_retract(q, p, v, xi):
    """NavState right retraction, ``xi = [dR(3), dp(3), dv(3)]``."""
    q2, p2 = se3_retract(q, p, xi[..., :6])
    return q2, p2, v + xi[..., 6:9]


# ---------------------------------------------------------------------------
# S^2 gravity-direction manifold (GTSAM Unit3 equivalent)
# ---------------------------------------------------------------------------

def s2_basis(g):
    """Orthonormal 2-dof tangent basis B(g) [..., 3, 2] for unit vector g."""
    b1 = cross(g, _unit_x_or_y(g))
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    b2 = cross(g, b1)
    return torch.stack([b1, b2], dim=-1)


def s2_retract(g, delta):
    """g' = Exp(g x (B(g) delta)) g."""
    b = s2_basis(g)
    omega = cross(g, torch.einsum("...ij,...j->...i", b, delta))
    return quat_rotate(exp_so3(omega), g)


def s2_local(ga, gb):
    """Tangent delta at ga pointing to gb (inverse of s2_retract)."""
    b = s2_basis(ga)
    axis = cross(ga, gb)
    sin_t = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    cos_t = torch.sum(ga * gb, dim=-1, keepdim=True)
    theta = torch.atan2(sin_t, cos_t)
    axis = axis / torch.clamp(sin_t, min=1e-12)
    bd = cross(theta * axis, ga)
    return torch.einsum("...ij,...i->...j", b, bd)
