"""Gravity-aware IMU preintegration on torch tensors.

Port of ``mimosa_tpu/imu/preintegration.py``. The preintegrated deltas
(dR, dv, dp) are gravity-independent; gravity enters only in the residual's
prediction. Measurements arrive as fixed-size padded arrays with a validity
mask so the scan step keeps static shapes.

The JAX package composes per-sample elements with
``jax.lax.associative_scan``; here the same associative composition runs as
a log-step (Hillis-Steele) prefix loop: ceil(log2 N) batched rounds over at
most ``max_imu_per_segment`` rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.core.eigh3 import eigh3


class PreintState(NamedTuple):
    """Preintegrated IMU deltas between two states + bias Jacobians + cov.

    dq [4] quat of DeltaR_ij; dv, dp [3]; dt scalar total time; J_* [3,3]
    first-order Jacobians of the deltas wrt the gyro / accel bias; cov [9,9]
    covariance of (dR, dv, dp); bg, ba [3] the bias linearization point.
    Stacked states carry a leading batch dim on every field.
    """

    dq: torch.Tensor
    dv: torch.Tensor
    dp: torch.Tensor
    dt: torch.Tensor
    J_dr_bg: torch.Tensor
    J_dv_bg: torch.Tensor
    J_dv_ba: torch.Tensor
    J_dp_bg: torch.Tensor
    J_dp_ba: torch.Tensor
    cov: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor


def init_preint(bg, ba, dtype=None, device=None) -> PreintState:
    dtype = dtype or bg.dtype
    device = device or bg.device
    z3 = torch.zeros((3, 3), dtype=dtype, device=device)
    return PreintState(
        dq=lie.quat_identity(dtype, device),
        dv=torch.zeros(3, dtype=dtype, device=device),
        dp=torch.zeros(3, dtype=dtype, device=device),
        dt=torch.zeros((), dtype=dtype, device=device),
        J_dr_bg=z3, J_dv_bg=z3, J_dv_ba=z3, J_dp_bg=z3, J_dp_ba=z3,
        cov=torch.zeros((9, 9), dtype=dtype, device=device),
        bg=bg.to(dtype), ba=ba.to(dtype),
    )


def _blocks(rows):
    """[[A, B, C], ...] of [..., 3, 3] blocks -> one [..., 3r, 3c] matrix."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _single_sample_elements(accs, gyros, dts, bg, ba, acc_var, gyro_var,
                            int_var, valid):
    """Per-sample elements relative to each sample's own start frame — the
    leaves of the associative composition. Invalid (padding) rows become
    exact identity elements."""
    n = accs.shape[0]
    dtype, device = accs.dtype, accs.device
    w = gyros - bg
    a = accs - ba
    dt = torch.where(valid, dts, torch.zeros_like(dts))[:, None]
    dq = lie.exp_so3(w * dt)
    Jr = lie.right_jacobian_so3(w * dt)
    z33 = torch.zeros((n, 3, 3), dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3)
    dtc = dt[..., None]
    d1 = dt[:, 0]
    gv = gyro_var / torch.clamp(d1, min=1e-9)
    av = acc_var / torch.clamp(d1, min=1e-9)
    s = lambda x: x[:, None, None]  # noqa: E731
    cross_av = eye * s(av * 0.5 * d1 ** 3)
    cov = _blocks([
        [Jr @ Jr.transpose(-1, -2) * s(gv * d1 ** 2), z33, z33],
        [z33, eye * s(av * d1 ** 2), cross_av],
        [z33, cross_av, eye * s(av * 0.25 * d1 ** 4 + int_var * d1)],
    ])
    J = torch.cat([
        torch.cat([-Jr * dtc, z33], dim=-1),
        torch.cat([z33, -eye * dtc], dim=-1),
        torch.cat([z33, -0.5 * eye * dtc * dtc], dim=-1),
    ], dim=-2)                                      # [n, 9, 6]
    return dict(dq=dq, dv=a * dt, dp=0.5 * a * dt * dt, dt=d1, J=J, cov=cov)


def _compose(a, b):
    """Associative composition of preintegration elements: a then b.

    Error-state transition of a's errors through b:
      dphi = R_b^T dphi_a + dphi_b
      dv   = dv_a - R_a [Dv_b]x dphi_a + R_a dv_b
      dp   = dp_a + dv_a Dt_b - R_a [Dp_b]x dphi_a + R_a dp_b
    """
    Ra = lie.quat_to_mat(a["dq"])
    Rb = lie.quat_to_mat(b["dq"])
    batch = a["dv"].shape[:-1]
    eye = torch.eye(3, dtype=Ra.dtype, device=Ra.device).expand(
        batch + (3, 3))
    z = torch.zeros_like(eye)
    dtb = b["dt"][..., None, None]
    F = _blocks([[Rb.transpose(-1, -2), z, z],
                 [-Ra @ lie.hat(b["dv"]), eye, z],
                 [-Ra @ lie.hat(b["dp"]), eye * dtb, eye]])
    G = _blocks([[eye, z, z], [z, Ra, z], [z, z, Ra]])
    return dict(
        dq=lie.quat_mul(a["dq"], b["dq"]),
        dv=a["dv"] + torch.einsum("...ij,...j->...i", Ra, b["dv"]),
        dp=(a["dp"] + a["dv"] * b["dt"][..., None]
            + torch.einsum("...ij,...j->...i", Ra, b["dp"])),
        dt=a["dt"] + b["dt"],
        J=F @ a["J"] + G @ b["J"],
        cov=(F @ a["cov"] @ F.transpose(-1, -2)
             + G @ b["cov"] @ G.transpose(-1, -2)),
    )


def _prefix_scan(elems):
    """Inclusive prefix composition (Hillis-Steele): after the round with
    stride d, row i holds the composition of rows max(0, i-2d+1)..i."""
    n = elems["dv"].shape[0]
    d = 1
    while d < n:
        c = _compose({k: v[:-d] for k, v in elems.items()},
                     {k: v[d:] for k, v in elems.items()})
        elems = {k: torch.cat([elems[k][:d], c[k]], dim=0) for k in elems}
        d *= 2
    return elems


def preintegrate(accs, gyros, dts, bg, ba, acc_var, gyro_var,
                 int_var=1e-8, valid=None, return_prefixes=False):
    """Preintegrate a padded batch of IMU samples [N] (prefix composition).
    With ``return_prefixes`` every field keeps the leading dim N: the
    cumulative element after each sample (the deskew pose replay)."""
    dtype = accs.dtype
    if valid is None:
        valid = torch.ones(accs.shape[0], dtype=torch.bool,
                           device=accs.device)
    bg, ba = bg.to(dtype), ba.to(dtype)
    pref = _prefix_scan(_single_sample_elements(
        accs, gyros, dts, bg, ba, acc_var, gyro_var, int_var, valid))
    if not return_prefixes:
        pref = {k: v[-1] for k, v in pref.items()}
    J = pref["J"]
    return PreintState(
        dq=pref["dq"], dv=pref["dv"], dp=pref["dp"], dt=pref["dt"],
        J_dr_bg=J[..., 0:3, 0:3], J_dv_bg=J[..., 3:6, 0:3],
        J_dv_ba=J[..., 3:6, 3:6], J_dp_bg=J[..., 6:9, 0:3],
        J_dp_ba=J[..., 6:9, 3:6], cov=pref["cov"], bg=bg, ba=ba,
    )


def _integrate_one(state: PreintState, acc, gyro, dt, acc_var, gyro_var,
                   int_var) -> PreintState:
    """One measurement's preintegration update (Forster eq. 35-46 style)."""
    w = gyro - state.bg
    a = acc - state.ba
    dR_prev = lie.quat_to_mat(state.dq)      # R of Delta_ij so far
    dq_inc = lie.exp_so3(w * dt)
    Jr = lie.right_jacobian_so3(w * dt)
    a_rot = dR_prev @ a                      # acceleration in frame i
    A = lie.hat(a)
    dR_inc_T = lie.quat_to_mat(dq_inc).T
    dRA = dR_prev @ A
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    z = torch.zeros_like(eye)
    # covariance propagation on (dR, dv, dp)
    F = _blocks([[dR_inc_T, z, z], [-dRA * dt, eye, z],
                 [-0.5 * dRA * dt * dt, eye * dt, eye]])
    G_g = torch.cat([Jr * dt, z, z], dim=0)
    G_a = torch.cat([z, dR_prev * dt, 0.5 * dR_prev * dt * dt], dim=0)
    cov = (F @ state.cov @ F.T
           + G_g @ G_g.T * (gyro_var / torch.clamp(dt, min=1e-9))
           + G_a @ G_a.T * (acc_var / torch.clamp(dt, min=1e-9)))
    # position integration noise
    cov = cov + torch.block_diag(z, z, eye * int_var * dt)
    return PreintState(
        dq=lie.quat_mul(state.dq, dq_inc), dv=state.dv + a_rot * dt,
        dp=state.dp + state.dv * dt + 0.5 * a_rot * dt * dt,
        dt=state.dt + dt,
        J_dr_bg=dR_inc_T @ state.J_dr_bg - Jr * dt,
        J_dv_bg=state.J_dv_bg - dRA @ state.J_dr_bg * dt,
        J_dv_ba=state.J_dv_ba - dR_prev * dt,
        J_dp_bg=(state.J_dp_bg + state.J_dv_bg * dt
                 - 0.5 * dRA @ state.J_dr_bg * dt * dt),
        J_dp_ba=state.J_dp_ba + state.J_dv_ba * dt - 0.5 * dR_prev * dt * dt,
        cov=cov, bg=state.bg, ba=state.ba)


def preintegrate_sequential(accs, gyros, dts, bg, ba, acc_var, gyro_var,
                            int_var=1e-8, valid=None) -> PreintState:
    """The sequential oracle of :func:`preintegrate`: one update a sample,
    in order; an invalid sample leaves the state as it was."""
    dtype = accs.dtype
    state = init_preint(bg.to(dtype), ba.to(dtype))
    if valid is None:
        valid = torch.ones(accs.shape[0], dtype=torch.bool,
                           device=accs.device)
    for acc, gyro, dt, ok in zip(accs, gyros, dts, valid):
        new = _integrate_one(state, acc, gyro, dt, acc_var, gyro_var,
                             int_var)
        state = PreintState(*[torch.where(ok, n, o)
                              for n, o in zip(new, state)])
    return state


def predict(pre: PreintState, q_i, p_i, v_i, gravity):
    """Forward prediction of state j from state i; ``gravity`` is the full
    free-fall acceleration in world (g_dir * g_mag)."""
    dt = pre.dt
    R_i = lie.quat_to_mat(q_i)
    p_j = p_i + v_i * dt + 0.5 * gravity * dt * dt + R_i @ pre.dp
    v_j = v_i + gravity * dt + R_i @ pre.dv
    return lie.quat_mul(q_i, pre.dq), p_j, v_j


def correct_deltas(pre: PreintState, bg, ba):
    """First-order bias-corrected deltas at a new bias linearization point."""
    dbg = bg - pre.bg
    dba = ba - pre.ba
    dq = lie.quat_mul(pre.dq, lie.exp_so3(pre.J_dr_bg @ dbg))
    dv = pre.dv + pre.J_dv_bg @ dbg + pre.J_dv_ba @ dba
    dp = pre.dp + pre.J_dp_bg @ dbg + pre.J_dp_ba @ dba
    return dq, dv, dp


def residual(pre: PreintState, q_i, p_i, v_i, q_j, p_j, v_j, bg, ba, g_dir,
             g_mag):
    """9-dof gravity-aware preintegration residual (r_dR, r_dv, r_dp) in
    frame i; ``g_dir`` is the free unit gravity direction, ``g_mag`` fixed."""
    gravity = g_dir * g_mag
    dq_c, dv_c, dp_c = correct_deltas(pre, bg, ba)
    dt = pre.dt
    R_i_T = lie.quat_to_mat(q_i).transpose(-1, -2)
    q_ij = lie.quat_mul(lie.quat_conj(q_i), q_j)
    r_dR = lie.log_so3(lie.quat_mul(lie.quat_conj(dq_c), q_ij))
    r_dv = R_i_T @ (v_j - v_i - gravity * dt) - dv_c
    r_dp = R_i_T @ (p_j - p_i - v_i * dt - 0.5 * gravity * dt * dt) - dp_c
    return torch.cat([r_dR, r_dv, r_dp])


def make_residual_fn(g_mag):
    """Residual as a function of tangent perturbations, for
    ``torch.func.jacfwd``: ``f(xi_i, xi_j, xi_b, xi_g, pre, lin)`` with
    xi_i/xi_j [9] navstate tangents, xi_b [6] (bg, ba), xi_g [2] S^2 and
    ``lin`` = (q_i, p_i, v_i, q_j, p_j, v_j, bg, ba, g_dir)."""

    def f(xi_i, xi_j, xi_b, xi_g, pre, lin):
        q_i, p_i, v_i, q_j, p_j, v_j, bg, ba, g_dir = lin
        qi2, pi2, vi2 = lie.navstate_retract(q_i, p_i, v_i, xi_i)
        qj2, pj2, vj2 = lie.navstate_retract(q_j, p_j, v_j, xi_j)
        return residual(pre, qi2, pi2, vi2, qj2, pj2, vj2,
                        bg + xi_b[:3], ba + xi_b[3:],
                        lie.s2_retract(g_dir, xi_g), g_mag)

    return f


def localizability(pre: PreintState, q_i, p_i, v_i, q_j, p_j, v_j, bg, ba,
                   g_dir, g_mag):
    """Eigen-analysis of the whitened IMU-factor Hessian over the second
    state's (rot, vel, pos) tangent: eigenvalues ascending + eigenvectors."""
    f = make_residual_fn(g_mag)
    kw = dict(dtype=p_i.dtype, device=p_i.device)
    z9 = torch.zeros(9, **kw)
    lin = (q_i, p_i, v_i, q_j, p_j, v_j, bg, ba, g_dir)
    Jj = jacfwd(f, argnums=1)(z9, z9, torch.zeros(6, **kw),
                              torch.zeros(2, **kw), pre, lin)
    L, _ = torch.linalg.cholesky_ex(pre.cov + torch.eye(9, **kw) * 1e-10)
    Jw = torch.linalg.solve_triangular(L, Jj, upper=False)
    H = Jw.T @ Jw
    lam_r, V_r = eigh3(H[0:3, 0:3])
    lam_p, V_p = eigh3(H[3:6, 3:6])
    lam_v, V_v = eigh3(H[6:9, 6:9])
    return dict(eig_rot=lam_r, vec_rot=V_r, eig_pos=lam_p, vec_pos=V_p,
                eig_vel=lam_v, vec_vel=V_v, H=H)
