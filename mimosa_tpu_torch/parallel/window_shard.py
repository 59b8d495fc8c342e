"""Window sharding: distributed Schur-complement batch adjustment.

Port of ``mimosa_tpu/parallel/window_shard.py``. A batch window of K
states (a whole trajectory, for the offline smoother of ``graph/refine``)
is split into ``n_wp`` contiguous chunks of Kc = K / n_wp states, one
chunk a rank of a ``torch.distributed`` process group.

The normal equations of (IMU chain + bias random walks + per-state
measurement quadratics + anchor priors) are block-tridiagonal in the
states with a dense 2-column gravity border. Domain decomposition solves
them exactly:

1. each rank linearizes and assembles only its chunk's factor blocks,
2. eliminates its chunk-interior states by an equilibrated local Schur
   complement onto its borders (left interface state, right interface
   state, gravity),
3. ``all_reduce`` sums the interface system (n_wp*15 + 2 dims) that every
   rank then solves,
4. back-substitutes its interior states; ``all_gather`` hands every rank
   the whole step.

The per-factor linearization is ``graph.window``'s IMU factor (the
``torch.func.jacfwd`` Jacobian under ``vmap``, whitened by the
preintegration covariance), so the sharded solve is numerically the system
``window.build_system`` assembles.

Where the JAX package names a mesh, the port takes ``group``: ``None`` is
world size 1 and needs no process group; otherwise the rank in the group
is the shard index and its size the shard count. Each rank holds the
whole inputs and returns the whole step, as the JAX package's replicated
and global arrays are. At world size 1 the one shard eliminates all K-1
interior states at once: a dense [(K-1)*15]^2 matrix.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.func import vmap

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.graph import window as win
from mimosa_tpu_torch.imu import preintegration as pre

SD = win.SD


def _idx(device):
    """(M26, BI): the factor's 26 columns [xi_i(9) | xi_j(9) | bias_i(6) |
    g(2)] in the 32-dim pair-local layout (state_i(15), state_j(15),
    g(2)), and the bias dims of state_i and state_j in that layout."""
    a = torch.arange(15, device=device)
    m26 = torch.cat([a[:9], 15 + a[:9], a[9:15],
                     torch.tensor([30, 31], device=device)])
    return m26, torch.cat([a[9:15], 15 + a[9:15]])


def _factor32(pre_c, f, q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, bg_j,
              ba_j, g_dir, cfg):
    """Every IMU + bias random-walk factor of a chunk as a 32x32 quadratic
    on (state_i, state_j, g): (A [Kc,32,32], rhs [Kc,32]) in the H dx = rhs
    convention, weighted by ``f`` [Kc] (0 for an invalid factor). The
    batched form of the JAX package's per-factor ``_factor32``, with the
    whitening, bias random-walk weights and signs of
    ``window.build_system``."""
    dtype, dev = p_i.dtype, p_i.device
    n = f.shape[0]
    m26, bi = _idx(dev)
    J, r = vmap(win._imu_jac_res, in_dims=(0,) * 9 + (None, None))(
        pre_c, q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, g_dir, cfg.g_mag)
    J, r = win._whiten(win._cov_cholesky(pre_c.cov), J, r)
    f = f.to(dtype)
    A = torch.zeros((n, 32, 32), dtype=dtype, device=dev)
    A[:, m26[:, None], m26[None, :]] = \
        J.transpose(-1, -2) @ J * f[:, None, None]
    rhs = torch.zeros((n, 32), dtype=dtype, device=dev)
    rhs[:, m26] = -torch.einsum("kai,ka->ki", J, r) * f[:, None]

    # bias random walk between factor: the weights and signs of
    # window._bias_rw_blocks / build_system
    dt = torch.clamp(pre_c.dt, min=1e-3)
    wg = f / (cfg.sigma_bg_rw ** 2 * dt)
    wa = f / (cfg.sigma_ba_rw ** 2 * dt)
    Wd = torch.cat([wg[:, None].expand(n, 3), wa[:, None].expand(n, 3)], 1)
    rr = torch.cat([bg_j - bg_i, ba_j - ba_i], dim=1).to(dtype)
    Wm = torch.diag_embed(Wd)
    Hb = torch.cat([torch.cat([Wm, -Wm], 2), torch.cat([-Wm, Wm], 2)], 1)
    A = A.index_put((torch.arange(n, device=dev)[:, None, None],
                     bi[None, :, None], bi[None, None, :]), Hb,
                    accumulate=True)
    rhs = rhs.index_put((torch.arange(n, device=dev)[:, None],
                         bi[None, :]), torch.cat([Wd * rr, -(Wd * rr)], 1),
                        accumulate=True)
    return A, rhs


def _equilibrated_solve_cols(T, Y):
    """x = T^-1 Y for an SPD-damped T: Jacobi equilibration and one step of
    iterative refinement (the ``window.solve`` / ``marginalize_oldest``
    recipe)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(T), min=1e-12))
    Ts = T / d[:, None] / d[None, :]
    Ys = Y / d[:, None]
    sol = torch.linalg.solve(Ts, Ys)
    sol = sol + torch.linalg.solve(Ts, Ys - Ts @ sol)
    return sol / d[:, None]


def _shard_body(q, p, v, bg, ba, g_dir, prior, pre_c, fv_c, measH_c,
                measb_c, *, cfg, c, n_wp, Kc, K, group=None):
    """Shard ``c`` of ``n_wp``: assemble its chunk's blocks, Schur-eliminate
    its interiors, sum the interface system over the group and solve it,
    back-substitute. Returns (dx of the chunk's states [Kc,15], dg [2])."""
    dtype, dev = p.dtype, p.device
    H0, r0, Hg, rg = prior
    ar = torch.arange(Kc, device=dev)

    # factor slot j of this shard = global factor c*Kc + j - 1
    gi = c * Kc + ar - 1
    valid = (gi >= 0) & fv_c
    si = torch.clamp(gi, 0, K - 2)
    sj = si + 1
    A_all, rhs_all = _factor32(
        pre_c, valid, q[si], p[si], v[si], bg[si], ba[si], q[sj], p[sj],
        v[sj], bg[sj], ba[sj], g_dir, cfg)

    # local extended layout: ext state 0 = left interface (the last state
    # of chunk c-1), ext 1..Kc = the owned states (ext Kc = the right
    # interface), then g
    M = (Kc + 1) * SD + 2
    goff = (Kc + 1) * SD
    gcols = torch.arange(goff, goff + 2, device=dev)
    eidx = torch.cat([ar[:, None] * SD + torch.arange(2 * SD, device=dev),
                      gcols.expand(Kc, 2)], dim=1)               # [Kc,32]
    Hloc = torch.zeros((M, M), dtype=dtype, device=dev).index_put(
        (eidx[:, :, None], eidx[:, None, :]), A_all, accumulate=True)
    rloc = torch.zeros(M, dtype=dtype, device=dev).index_put(
        (eidx,), rhs_all, accumulate=True)

    # per-state measurement quadratics + damping on the owned states
    sidx = (1 + ar)[:, None] * SD + torch.arange(SD, device=dev)
    Hloc = Hloc.index_put((sidx[:, :, None], sidx[:, None, :]),
                          measH_c.to(dtype), accumulate=True)
    rloc = rloc.index_put((sidx,), -measb_c.to(dtype), accumulate=True)
    diag_own = torch.zeros(M, dtype=dtype, device=dev)
    diag_own[sidx.reshape(-1)] = cfg.damping
    if c == 0:
        # gravity damping and the anchor priors, added once (by shard 0)
        diag_own[goff:] = cfg.damping
    Hloc = Hloc + torch.diag(diag_own)
    if c == 0:
        s0 = SD + torch.arange(SD, device=dev)    # ext 1 = global state 0
        Hloc[s0[:, None], s0[None, :]] += H0
        rloc[s0] -= H0 @ r0
        Hloc[goff:, goff:] += Hg
        rloc[goff:] -= Hg @ rg

    # local Schur complement of the interiors (ext 1..Kc-1) onto the
    # border [L(15), R(15), g(2)]
    bidx = torch.cat([torch.arange(SD, device=dev),
                      Kc * SD + torch.arange(SD, device=dev), gcols])
    T = Hloc[SD:Kc * SD, SD:Kc * SD]
    Ub = Hloc[SD:Kc * SD][:, bidx]                              # [ni,32]
    Abb = Hloc[bidx[:, None], bidx[None, :]]
    ri = rloc[SD:Kc * SD]
    rb = rloc[bidx]
    sol = _equilibrated_solve_cols(T, torch.cat([Ub, ri[:, None]], dim=1))
    S = Abb - Ub.T @ sol[:, :-1]
    srb = rb - Ub.T @ sol[:, -1]

    # the global interface system [iface_0 .. iface_{n_wp-1}, g]; shard 0
    # has no left interface: its S rows and columns for L are exactly zero
    # (no factor and no damping touches L there), so the clipped scatter
    # adds zeros
    B = n_wp * SD + 2
    a15 = torch.arange(SD, device=dev)
    idxb = torch.cat([(c - 1) * SD + a15, c * SD + a15,
                      torch.arange(n_wp * SD, B, device=dev)])
    idxb = torch.clamp(idxb, 0, B - 1)
    Gm = torch.zeros((B, B), dtype=dtype, device=dev).index_put(
        (idxb[:, None], idxb[None, :]), S, accumulate=True)
    gvec = torch.zeros(B, dtype=dtype, device=dev).index_put(
        (idxb,), srb, accumulate=True)
    if group is not None:
        dist.all_reduce(Gm, group=group)
        dist.all_reduce(gvec, group=group)
    xb = win.solve(Gm, gvec)                 # on every rank, equilibrated

    # back-substitute the interiors; the owned dx = interiors + the right
    # interface
    x_int = sol[:, -1] - sol[:, :-1] @ xb[idxb]  # L part zero-coupled on 0
    dx_own = torch.cat([x_int.reshape(Kc - 1, SD),
                        xb[c * SD:(c + 1) * SD][None]], dim=0)
    return dx_own, xb[-2:]


def _chunk_factors(preints, factor_valid):
    """Pad the [K-1] factor chain to [K] with a leading dummy, so slot j of
    chunk c is global factor c*Kc + j - 1 (shard 0's slot 0 is invalid)."""
    padded = pre.PreintState(*[torch.cat([a[:1], a]) for a in preints])
    fv = torch.cat([torch.zeros_like(factor_valid[:1]), factor_valid])
    return padded, fv


def shards(group=None):
    """(shard index, shard count) of this process: its rank in ``group``
    and the group's size, or (0, 1) without a group."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def distributed_gn_step(q, p, v, bg, ba, g_dir, preints: pre.PreintState,
                        factor_valid, meas_H, meas_b, cfg: win.WindowConfig,
                        prior, group=None):
    """One exact Gauss-Newton step of the K-state batch window, the states
    split over the ranks of ``group`` (``None``: one shard, no process
    group).

    q [K,4] .. ba [K,3], g_dir [3]; preints / factor_valid [K-1] the IMU
    chain; meas_H [K,15,15] / meas_b [K,15] the per-state measurement
    quadratics (H dx = rhs convention, rhs -= b); prior = (H0 [15,15],
    r0 [15], Hg [2,2], rg [2]), the anchor prior on state 0 and gravity with
    residuals at the current estimate. Every rank passes the whole inputs
    and gets the whole step: (dx [K,15], dg [2]), the solution of
    ``window.build_system`` + ``window.solve`` on the equivalent dense
    system."""
    K = q.shape[0]
    c, n_wp = shards(group)
    if K % n_wp or K // n_wp < 2:
        raise ValueError(f"K={K} must be a multiple of n_wp={n_wp} with "
                         f">=2 states per shard")
    Kc = K // n_wp
    pre_f, fv_f = _chunk_factors(preints, factor_valid)
    own = slice(c * Kc, (c + 1) * Kc)
    dx_own, dg = _shard_body(
        q, p, v, bg, ba, g_dir, prior,
        pre.PreintState(*[a[own] for a in pre_f]), fv_f[own], meas_H[own],
        meas_b[own], cfg=cfg, c=c, n_wp=n_wp, Kc=Kc, K=K, group=group)
    if group is None:
        return dx_own, dg
    parts = [torch.empty_like(dx_own) for _ in range(n_wp)]
    dist.all_gather(parts, dx_own.contiguous(), group=group)
    return torch.cat(parts), dg


def anchor_prior(q, p, v, bg, ba, g_dir, anchor, cfg: win.WindowConfig):
    """(H0, r0, Hg, rg) pulling state 0 and gravity to ``anchor`` =
    (q0, p0, v0, bg0, ba0, g0) with the WindowConfig's initial sigmas."""
    dtype, dev = p.dtype, p.device
    diag = torch.cat([
        torch.full((3,), 1.0 / s ** 2, dtype=dtype, device=dev)
        for s in (cfg.init_sigma_rot, cfg.init_sigma_pos, cfg.init_sigma_vel,
                  cfg.init_sigma_bg, cfg.init_sigma_ba)])
    q0, p0, v0, bg0, ba0, g0 = anchor
    r0 = torch.cat([lie.se3_local(q0, p0, q[0], p[0]), v[0] - v0,
                    bg[0] - bg0, ba[0] - ba0]).to(dtype)
    Hg = torch.eye(2, dtype=dtype, device=dev) / cfg.init_sigma_grav ** 2
    rg = lie.s2_local(g0, g_dir).to(dtype)
    return torch.diag(diag), r0, Hg, rg


def batch_adjust(q, p, v, bg, ba, g_dir, preints, factor_valid, meas_fn,
                 cfg: win.WindowConfig, iters=3, group=None):
    """Distributed batch trajectory adjustment: ``iters`` Gauss-Newton
    rounds, each relinearizing the measurements through
    ``meas_fn(q, p, v, bg, ba, g_dir) -> (meas_H [K,15,15], meas_b [K,15])``
    and anchoring the prior at the initial state 0 and gravity (batch
    smoothing keeps the gauge). Runs op by op: the smoother runs once a
    replay. Returns (q, p, v, bg, ba, g_dir)."""
    anchor = (q[0], p[0], v[0], bg[0], ba[0], g_dir)
    for _ in range(iters):
        meas_H, meas_b = meas_fn(q, p, v, bg, ba, g_dir)
        prior = anchor_prior(q, p, v, bg, ba, g_dir, anchor, cfg)
        dx, dg = distributed_gn_step(q, p, v, bg, ba, g_dir, preints,
                                     factor_valid, meas_H, meas_b, cfg,
                                     prior, group=group)
        q2, p2 = lie.se3_retract(q, p, dx[:, :6])
        q, p, v, bg, ba, g_dir = (q2, p2, v + dx[:, 6:9], bg + dx[:, 9:12],
                                  ba + dx[:, 12:15],
                                  lie.s2_retract(g_dir, dg))
    return q, p, v, bg, ba, g_dir
