"""Dense sliding-window Gauss-Newton fusion core.

Port of ``mimosa_tpu/graph/window.py``. The window is a dense block state

    x = [ state_0 (15) | ... | state_{K-1} (15) | g (2) ]

with per-state tangent [dR(3), dp(3), dv(3), dbg(3), dba(3)] and a shared
2-dof gravity direction. The fixed lag is Schur-complement marginalization
of the oldest state into a dense Gaussian prior anchored at per-state
linearization points; finalized measurement blocks are absorbed into it.

IMU-factor Jacobians come from ``torch.func.jacfwd`` under
``torch.func.vmap`` (the JAX package's ``jax.jacfwd`` inside ``jax.vmap``).
The small dense factorizations stay ``torch.linalg`` calls, in their
``_ex`` forms so nothing waits on the device to check an error code: a
failed factorization degrades the update to zero, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.imu import preintegration as pre

SD = 15  # per-state tangent dim


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    K: int = 8                         # max states in window
    g_mag: float = 9.81
    damping: float = 1e-6              # LM damping added to H diagonal
    # bias random walk densities (sigma * sqrt(dt) between-factor)
    sigma_bg_rw: float = 1e-4
    sigma_ba_rw: float = 1e-3
    # initial priors
    init_sigma_rot: float = 0.05
    init_sigma_pos: float = 1e-3
    init_sigma_vel: float = 0.05
    init_sigma_bg: float = 1e-2
    init_sigma_ba: float = 1e-1
    init_sigma_grav: float = 0.05

    @property
    def D(self) -> int:
        return self.K * SD + 2


class Window(NamedTuple):
    # current estimates
    q: torch.Tensor       # [K,4]
    p: torch.Tensor       # [K,3]
    v: torch.Tensor       # [K,3]
    bg: torch.Tensor      # [K,3]
    ba: torch.Tensor      # [K,3]
    g_dir: torch.Tensor   # [3] unit, direction of gravitational acceleration
    ts: torch.Tensor      # [K] segment-relative timestamps (0 if inactive)
    active: torch.Tensor  # [K] bool
    # Gaussian prior: E(x) = 0.5 d^T H d + b^T d, d = x [-] lin
    H_prior: torch.Tensor  # [D,D]
    b_prior: torch.Tensor  # [D]
    lin_q: torch.Tensor
    lin_p: torch.Tensor
    lin_v: torch.Tensor
    lin_bg: torch.Tensor
    lin_ba: torch.Tensor
    lin_g: torch.Tensor


def create(cfg: WindowConfig, device=None, dtype=torch.float32) -> Window:
    K, D = cfg.K, cfg.D
    f = dict(dtype=dtype, device=device)
    q0 = lie.quat_identity(dtype, device).expand(K, 4).clone()
    z3 = torch.zeros((K, 3), **f)
    g = torch.zeros(3, **f)
    g[2] = -1.0
    return Window(
        q=q0, p=z3, v=z3, bg=z3, ba=z3, g_dir=g,
        ts=torch.zeros(K, **f),
        active=torch.zeros(K, dtype=torch.bool, device=device),
        H_prior=torch.zeros((D, D), **f), b_prior=torch.zeros(D, **f),
        lin_q=q0, lin_p=z3, lin_v=z3, lin_bg=z3, lin_ba=z3, lin_g=g,
    )


# ---------------------------------------------------------------------------
# tangent bookkeeping
# ---------------------------------------------------------------------------

def local_delta(w: Window, cfg: WindowConfig):
    """d = current [-] lin, the prior's evaluation point. [D]"""
    dr_dp = lie.se3_local(w.lin_q, w.lin_p, w.q, w.p)          # [K,6]
    per_state = torch.cat([dr_dp, w.v - w.lin_v, w.bg - w.lin_bg,
                           w.ba - w.lin_ba], dim=-1)             # [K,15]
    return torch.cat([per_state.reshape(-1), lie.s2_local(w.lin_g, w.g_dir)])


def apply_update(w: Window, dx, cfg: WindowConfig) -> Window:
    """Retract tangent update onto all active states + gravity."""
    K = cfg.K
    dxs = dx[: K * SD].reshape(K, SD)
    dxs = torch.where(w.active[:, None], dxs, torch.zeros_like(dxs))
    q2, p2 = lie.se3_retract(w.q, w.p, dxs[:, :6])
    return w._replace(
        q=q2, p=p2, v=w.v + dxs[:, 6:9],
        bg=w.bg + dxs[:, 9:12], ba=w.ba + dxs[:, 12:15],
        g_dir=lie.s2_retract(w.g_dir, dx[K * SD:]),
    )


def rebase_prior(w: Window, cfg: WindowConfig) -> Window:
    """Shift the prior's linearization point to the current estimates
    (first-order): b <- b + H d, lin <- current."""
    d = local_delta(w, cfg).to(w.b_prior.dtype)
    return w._replace(
        b_prior=w.b_prior + w.H_prior @ d,
        lin_q=w.q, lin_p=w.p, lin_v=w.v, lin_bg=w.bg, lin_ba=w.ba,
        lin_g=w.g_dir,
    )


def init_priors(w: Window, cfg: WindowConfig) -> Window:
    """Anchor priors on slot 0 (X, V, B) and gravity."""
    kw = dict(dtype=w.H_prior.dtype, device=w.H_prior.device)
    diag = torch.zeros(cfg.D, **kw)
    for k, sigma in enumerate((cfg.init_sigma_rot, cfg.init_sigma_pos,
                               cfg.init_sigma_vel, cfg.init_sigma_bg,
                               cfg.init_sigma_ba)):
        diag[3 * k: 3 * k + 3] = 1.0 / sigma ** 2
    gi = cfg.K * SD
    diag[gi: gi + 2] = 1.0 / cfg.init_sigma_grav ** 2
    return w._replace(H_prior=w.H_prior + torch.diag(diag))


def pose_idx(slot):
    """Tangent indices of a state's pose block [dR(3), dp(3)]; ``slot`` may
    be a 0-d device tensor."""
    dev = slot.device if torch.is_tensor(slot) else None
    return slot * SD + torch.arange(6, device=dev)


def rot_vel_bg_idx(slot):
    """Tangent indices [dR(3), dv(3), dbg(3)] of a state (the radar Doppler
    keys); ``slot`` may be a 0-d device tensor."""
    dev = slot.device if torch.is_tensor(slot) else None
    a3 = torch.arange(3, device=dev)
    return slot * SD + torch.cat([a3, 6 + a3, 9 + a3])


def between_pose_idx(slot_i, slot_j):
    """Tangent indices of two states' pose blocks (the odometry between
    factor)."""
    return torch.cat([pose_idx(slot_i), pose_idx(slot_j)])


def add_block(H, rhs, idx, Hm, bm):
    """H[idx, idx] += Hm and rhs[idx] += bm; duplicate indices accumulate.
    ``idx`` is [m] or a batch [B, m] of index vectors (Hm [B, m, m])."""
    H = H.index_put((idx[..., :, None], idx[..., None, :]), Hm.to(H.dtype),
                    accumulate=True)
    return H, rhs.index_put((idx,), bm.to(rhs.dtype), accumulate=True)


def add_measurement_block(w: Window, idx, Hm, bm, cfg: WindowConfig) -> Window:
    """Absorb a finalized measurement quadratic (e.g. the scan's ICP factor)
    into the prior at the current linearization; call after
    ``rebase_prior``."""
    H, b = add_block(w.H_prior, w.b_prior, idx, Hm, bm)
    return w._replace(H_prior=H, b_prior=b)


# ---------------------------------------------------------------------------
# IMU chain factors
# ---------------------------------------------------------------------------

def _imu_jac_res(pre_i, q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, g_dir,
                 g_mag):
    """Unwhitened (J [9,26], r [9]) of one IMU factor."""
    f = pre.make_residual_fn(g_mag)
    kw = dict(dtype=p_i.dtype, device=p_i.device)
    z9 = torch.zeros(9, **kw)
    lin = (q_i, p_i, v_i, q_j, p_j, v_j, bg_i, ba_i, g_dir)

    def f_aux(*xi):
        r = f(*xi, pre_i, lin)
        return r, r

    jac, r = jacfwd(f_aux, argnums=(0, 1, 2, 3), has_aux=True)(
        z9, z9, torch.zeros(6, **kw), torch.zeros(2, **kw))
    return torch.cat(jac, dim=-1), r


def _cov_cholesky(cov):
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device)
    return torch.linalg.cholesky_ex(cov + eye * 1e-10)[0]


def _whiten(L, J, r):
    J_w = torch.linalg.solve_triangular(L, J, upper=False)
    r_w = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    return J_w, r_w


def imu_block(pre_i, q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, g_dir,
              g_mag):
    """Whitened Jacobian/residual of ONE gravity-augmented IMU factor:
    (J_w [9,26], r_w [9]) with columns [xi_i(9) | xi_j(9) | xi_bias_i(6) |
    xi_g(2)], whitened by the preintegration covariance."""
    J, r = _imu_jac_res(pre_i, q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j,
                        g_dir, g_mag)
    return _whiten(_cov_cholesky(pre_i.cov), J, r)


def _shifted_pairs(w: Window):
    """(state i fields, state i+1 fields) of all K-1 consecutive pairs."""
    return (w.q[:-1], w.p[:-1], w.v[:-1], w.bg[:-1], w.ba[:-1],
            w.q[1:], w.p[1:], w.v[1:])


def _imu_factor_blocks(w: Window, preints: pre.PreintState,
                       cfg: WindowConfig):
    """Linearize all K-1 consecutive IMU factors at current values:
    whitened (J [K-1,9,26], r [K-1,9]). The Jacobians are vmapped; the
    whitening runs on the batch outside the vmap."""
    J, r = vmap(_imu_jac_res, in_dims=(0,) * 9 + (None, None))(
        preints, *_shifted_pairs(w), w.g_dir, cfg.g_mag)
    return _whiten(_cov_cholesky(preints.cov), J, r)


def imu_factor_cache(w: Window, preints: pre.PreintState, cfg: WindowConfig):
    """(J_w [K-1,9,26], L [K-1,9,9]): whitened Jacobians + covariance
    Cholesky factors, computed once per scan and reused across GN
    iterations via ``build_system(..., imu_cache=...)``."""
    J, _ = _imu_factor_blocks(w, preints, cfg)
    return J, _cov_cholesky(preints.cov)


def imu_residuals_whitened(w: Window, preints: pre.PreintState, L,
                           cfg: WindowConfig):
    """Whitened IMU residuals [K-1,9] at current values with fixed Cholesky
    factors ``L`` [K-1,9,9]."""
    f = pre.make_residual_fn(cfg.g_mag)
    kw = dict(dtype=w.p.dtype, device=w.p.device)
    z9, z6, z2 = (torch.zeros(k, **kw) for k in (9, 6, 2))

    def one(pre_i, q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j):
        return f(z9, z9, z6, z2, pre_i,
                 (q_i, p_i, v_i, q_j, p_j, v_j, bg_i, ba_i, w.g_dir))

    r = vmap(one)(preints, *_shifted_pairs(w))
    return torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]


def _bias_rw_blocks(w: Window, preints: pre.PreintState, cfg: WindowConfig):
    """Bias random-walk between factors, whitened:
    r = (b_j - b_i) / (sigma * sqrt(dt))."""
    dt = torch.clamp(preints.dt, min=1e-3)
    sg = cfg.sigma_bg_rw * torch.sqrt(dt)
    sa = cfg.sigma_ba_rw * torch.sqrt(dt)
    r_bg = (w.bg[1:] - w.bg[:-1]) / sg[:, None]
    r_ba = (w.ba[1:] - w.ba[:-1]) / sa[:, None]
    return r_bg, r_ba, sg, sa


def _imu_idx(K, device):
    """[K-1, 26] window tangent indices of each IMU factor's columns:
    state i (9), state i+1 (9), bias i (6), gravity (2)."""
    a9, a6 = torch.arange(9, device=device), torch.arange(6, device=device)
    per = torch.cat([a9, SD + a9, 9 + a6])
    rows = torch.arange(K - 1, device=device)[:, None] * SD + per
    g = K * SD + torch.arange(2, device=device).expand(K - 1, 2)
    return torch.cat([rows, g], dim=1)


def _bias_idx(K, device):
    """[K-1, 12] tangent indices of the bias dims of states i and i+1."""
    a6 = torch.arange(6, device=device)
    per = torch.cat([9 + a6, SD + 9 + a6])
    return torch.arange(K - 1, device=device)[:, None] * SD + per


def build_system(w: Window, preints: pre.PreintState, factor_valid,
                 cfg: WindowConfig, meas=(), imu_cache=None):
    """Assemble normal equations H dx = rhs over the full window tangent.

    factor_valid: [K-1] bool, IMU factor between slot i and i+1 active.
    meas: (idx [m], H [m,m], b [m]) live measurement blocks (e.g. the scan's
    freshly linearized ICP factor), in the H dx = -b convention.
    """
    K, D = cfg.K, cfg.D
    dtype, dev = w.p.dtype, w.p.device

    # prior
    d0 = local_delta(w, cfg).to(dtype)
    H = w.H_prior.clone()
    rhs = -(w.H_prior @ d0 + w.b_prior)

    # IMU preintegration factors, one batched scatter-add (duplicate
    # indices, e.g. the shared gravity dims, accumulate)
    if imu_cache is not None:
        J, L = imu_cache
        r = imu_residuals_whitened(w, preints, L, cfg)
    else:
        J, r = _imu_factor_blocks(w, preints, cfg)
    fv = factor_valid.to(dtype)
    Hf = torch.einsum("kai,kaj,k->kij", J, J, fv)   # [K-1,26,26]
    bf = torch.einsum("kai,ka,k->ki", J, r, fv)     # [K-1,26]
    H, rhs = add_block(H, rhs, _imu_idx(K, dev), Hf, -bf)

    # bias random walk between factors: [[W,-W],[-W,W]] on the 12 bias
    # dims of each consecutive pair
    r_bg, r_ba, sg, sa = _bias_rw_blocks(w, preints, cfg)
    Wd = torch.cat([(fv / sg ** 2)[:, None].expand(K - 1, 3),
                    (fv / sa ** 2)[:, None].expand(K - 1, 3)], dim=1)
    Wm = torch.diag_embed(Wd)                       # [K-1,6,6]
    Hb = torch.cat([torch.cat([Wm, -Wm], dim=2),
                    torch.cat([-Wm, Wm], dim=2)], dim=1)
    rr = torch.cat([r_bg * sg[:, None], r_ba * sa[:, None]], dim=1)
    bb = torch.cat([Wd * rr, -(Wd * rr)], dim=1)    # [K-1,12]
    H, rhs = add_block(H, rhs, _bias_idx(K, dev), Hb, bb)

    for idx, Hm, bm in meas:
        H, rhs = add_block(H, rhs, idx, Hm, -bm)

    # inactive dims: identity rows, zero rhs
    act = torch.cat([w.active[:, None].expand(K, SD).reshape(-1),
                     torch.ones(2, dtype=torch.bool, device=dev)])
    H = torch.where(act[:, None] & act[None, :], H, torch.zeros_like(H))
    diag = torch.where(act, torch.full_like(rhs, cfg.damping),
                       torch.ones_like(rhs))
    return H + torch.diag(diag), torch.where(act, rhs, torch.zeros_like(rhs))


def solve(H, rhs):
    """Solve the small dense SPD system via Jacobi-equilibrated Cholesky.

    Symmetric diagonal scaling D^-1/2 H D^-1/2 removes the 1e7 .. 1e-1
    scale disparity an f32 Cholesky cannot take. If the factorization still
    fails, the update is zero: the state holds the IMU prediction instead
    of poisoning the window with NaNs."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    L, info = torch.linalg.cholesky_ex(H / d[:, None] / d[None, :])
    y = torch.linalg.solve_triangular(L, (rhs / d)[:, None], upper=False)
    dx = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0] / d
    ok = torch.isfinite(dx) & (info == 0)
    return torch.where(ok, dx, torch.zeros_like(dx))


# ---------------------------------------------------------------------------
# sliding: append + marginalize
# ---------------------------------------------------------------------------

def append_state(w: Window, q, p, v, bg, ba, ts) -> Window:
    """Place a new state in the first inactive slot (one-hot mask, so
    shapes stay static and nothing is read back)."""
    slot = torch.argmin(w.active.to(torch.int32))  # first False
    onehot = torch.arange(w.active.shape[0], device=slot.device) == slot
    sel = onehot[:, None]

    def put(new, old):
        return torch.where(sel, new, old)

    return w._replace(
        q=put(q, w.q), p=put(p, w.p), v=put(v, w.v), bg=put(bg, w.bg),
        ba=put(ba, w.ba),
        ts=torch.where(onehot, ts, w.ts),
        active=w.active | onehot,
        # linearization mirrors current for the fresh slot (zero delta)
        lin_q=put(q, w.lin_q), lin_p=put(p, w.lin_p), lin_v=put(v, w.lin_v),
        lin_bg=put(bg, w.lin_bg), lin_ba=put(ba, w.lin_ba),
    )


def marginalize_oldest(w: Window, preints: pre.PreintState,
                       cfg: WindowConfig) -> Window:
    """Schur-complement slot 0 out of (prior + IMU factor 0->1), then shift
    every slot left by one. ``preints`` is the full stacked [K-1] chain;
    only segment 0 is consumed."""
    K, D = cfg.K, cfg.D
    dtype, dev = w.p.dtype, w.p.device
    w = rebase_prior(w, cfg)

    # prior + the one IMU factor touching slot 0, at current values (d0 = 0)
    Jf, rf = _imu_factor_blocks(w, preints, cfg)
    J0, r0 = Jf[0], rf[0]
    H, b = add_block(w.H_prior, w.b_prior, _imu_idx(K, dev)[0], J0.T @ J0,
                     J0.T @ r0)
    # bias random walk 0 -> 1
    r_bg, r_ba, sg, sa = _bias_rw_blocks(w, preints, cfg)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    for off, sgm, rr in ((9, sg[0], r_bg[0] * sg[0]),
                         (12, sa[0], r_ba[0] * sa[0])):
        wgt = 1.0 / sgm ** 2
        idx = torch.cat([off + torch.arange(3, device=dev),
                         SD + off + torch.arange(3, device=dev)])
        blk = torch.cat([torch.cat([eye3, -eye3], 1),
                         torch.cat([-eye3, eye3], 1)], 0) * wgt
        H, b = add_block(H, b, idx, blk, torch.cat([wgt * rr, -wgt * rr]))

    # Schur complement out dims [0, 15), in the EQUILIBRATED basis end to
    # end: scaling H by D^-1/2 on both sides makes every entry O(1), so f32
    # rounding of the ~5e6-scale pose rows does not land in the small bias
    # and gravity blocks as an O(1) relative error
    dall = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H / dall[:, None] / dall[None, :]
    bs = b / dall
    Hkk = Hs[:SD, :SD] + torch.eye(SD, dtype=dtype, device=dev) * 1e-7
    Hkr = Hs[:SD, SD:]
    Hrr = Hs[SD:, SD:]
    rhs_all = torch.cat([Hkr, bs[:SD, None]], dim=1)
    sol = torch.linalg.solve_ex(Hkk, rhs_all)[0]
    # one step of iterative refinement (squares the f32 solve's residual)
    sol = sol + torch.linalg.solve_ex(Hkk, rhs_all - Hkk @ sol)[0]
    dr = dall[SD:]
    Hred = (Hrr - Hkr.T @ sol[:, :-1]) * dr[:, None] * dr[None, :]
    bred = (bs[SD:] - Hkr.T @ sol[:, -1]) * dr

    # embed the reduced system: old slots 1..K-1 -> new 0..K-2, g stays
    n_keep = (K - 1) * SD
    Hp = torch.zeros((D, D), dtype=dtype, device=dev)
    bp = torch.zeros(D, dtype=dtype, device=dev)
    Hp[:n_keep, :n_keep] = Hred[:n_keep, :n_keep]
    Hp[:n_keep, K * SD:] = Hred[:n_keep, n_keep:]
    Hp[K * SD:, :n_keep] = Hred[n_keep:, :n_keep]
    Hp[K * SD:, K * SD:] = Hred[n_keep:, n_keep:]
    bp[:n_keep] = bred[:n_keep]
    bp[K * SD:] = bred[n_keep:]

    def shift(a):
        return torch.cat([a[1:], a[-1:]], dim=0)

    # the freed last slot: zero time, inactive (by concatenation; setting
    # an element from a Python number would copy it from the host)
    return w._replace(
        q=shift(w.q), p=shift(w.p), v=shift(w.v), bg=shift(w.bg),
        ba=shift(w.ba), ts=torch.cat([w.ts[1:], torch.zeros_like(w.ts[:1])]),
        active=torch.cat([w.active[1:], torch.zeros_like(w.active[:1])]),
        H_prior=Hp, b_prior=bp,
        lin_q=shift(w.lin_q), lin_p=shift(w.lin_p), lin_v=shift(w.lin_v),
        lin_bg=shift(w.lin_bg), lin_ba=shift(w.lin_ba),
    )


def insert_state_at(w: Window, pos, q, p, v, bg, ba, ts,
                    cfg: WindowConfig) -> Window:
    """Insert a state at slot ``pos`` (a 0-d device tensor, >= 1), shifting
    slots >= pos right by one. Needs a free slot (the Sequencer
    marginalizes first when the window is full).

    The out-of-order counterpart of ``append_state``: the window inserts
    the state and the Sequencer re-integrates the two IMU segments around
    it. The prior is block-permuted with it; the inserted block's rows and
    columns are zero (the new state carries no prior). Every field is a
    gather through a device index vector, so nothing is read back and one
    captured step serves every position."""
    K, D = cfg.K, cfg.D
    dev = w.q.device
    src = torch.arange(K, device=dev)
    take = torch.where(src < pos, src, src - 1)   # right shift from pos
    at_pos = src == pos

    def shift_in(arr, new_val):
        sel = at_pos.reshape((K,) + (1,) * (arr.ndim - 1))
        return torch.where(sel, new_val, arr.index_select(0, take))

    # old block b goes to b if b < pos else b + 1; gravity stays
    tang_new = torch.arange(D, device=dev)
    blk_new = torch.clamp(tang_new // SD, max=K - 1)
    off = tang_new - blk_new * SD
    is_g = tang_new >= K * SD
    src_blk = torch.where(blk_new < pos, blk_new, blk_new - 1)
    src_idx = torch.where(is_g, tang_new, src_blk * SD + off)
    fresh = (~is_g) & (blk_new == pos)
    zero = torch.zeros((), dtype=w.H_prior.dtype, device=dev)
    Hp = w.H_prior[src_idx[:, None], src_idx[None, :]]
    Hp = torch.where(fresh[:, None] | fresh[None, :], zero, Hp)
    bp = torch.where(fresh, zero, w.b_prior.index_select(0, src_idx))

    return w._replace(
        q=shift_in(w.q, q), p=shift_in(w.p, p), v=shift_in(w.v, v),
        bg=shift_in(w.bg, bg), ba=shift_in(w.ba, ba),
        ts=shift_in(w.ts, ts),
        active=shift_in(w.active, torch.ones_like(w.active[0])),
        H_prior=Hp, b_prior=bp,
        lin_q=shift_in(w.lin_q, q), lin_p=shift_in(w.lin_p, p),
        lin_v=shift_in(w.lin_v, v), lin_bg=shift_in(w.lin_bg, bg),
        lin_ba=shift_in(w.lin_ba, ba),
    )


def newest_slot(w: Window):
    """Index of the newest active slot (a 0-d device tensor)."""
    return w.active.to(torch.int32).sum() - 1
