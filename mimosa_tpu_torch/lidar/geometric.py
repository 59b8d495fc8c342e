"""Geometric scan-to-map point-to-plane ICP linearization.

Port of ``mimosa_tpu/lidar/geometric.py``: correspondences are the nearest
precomputed voxel planes (``match``); the linearization gates each point by
residual distance and the s-score ``1 - 0.9|r|/sqrt(|p|)``, weights it with
Huber, and accumulates the 6x6 normal equations plus the localizability
analysis (eigen-analysis of the unweighted rotation / translation blocks
and per-point projection counts), with the optional 4-DoF projection.

``linearize_with`` is the plain PyTorch version of the CUDA kernel in
``ops/icp_cuda.py``: the CPU path, and the kernel's reference on the card.
``linearize_binary`` is the two-key (scan-to-scan) form of the factor, in
plain PyTorch on either device (the JAX package computes it in XLA).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mimosa_tpu_torch.core import lie
from mimosa_tpu_torch.core.eigh3 import eigh3
from mimosa_tpu_torch.mapping import voxel_hash as vh

# rejection status indices (debug counters)
STATUS_INLIER = 0
STATUS_NO_PLANE = 1
STATUS_MAX_DIST = 2
STATUS_S_GATE = 3
NUM_STATUS = 4


@dataclasses.dataclass(frozen=True)
class GeometricConfig:
    sigma: float = 0.05               # point-to-plane noise stdev [m]
    huber_delta: float = 0.1          # Huber kernel threshold on |r| [m]
    s_gate_min: float = 0.9           # s-score gate
    max_p2p_dist: float = 0.5         # hard residual gate [m]
    loc_proj_cutoff: float = 0.5      # per-point |J·v| cutoff
    loc_count_thresh: float = 120.0   # min #strong points per trans axis
    loc_count_thresh_rot: float = 120.0  # min #strong points per rot axis
    use_4dof: bool = False            # project out world roll/pitch
    project_degenerate: bool = False  # zero GN update in weak directions


class ICPResult(NamedTuple):
    H: torch.Tensor               # [6,6] sum w J^T J / sigma^2 ([dR, dt])
    b: torch.Tensor               # [6]   sum w J^T r / sigma^2
    num_inlier: torch.Tensor      # int32 scalar
    status_counts: torch.Tensor   # [NUM_STATUS] int32
    mean_abs_res: torch.Tensor    # inlier mean |r|
    loc_counts_rot: torch.Tensor    # [3] strong-point counts per rot eigvec
    loc_counts_trans: torch.Tensor  # [3]
    eigvals_rot: torch.Tensor       # [3] ascending, of the H rot block
    eigvals_trans: torch.Tensor     # [3]
    eigvecs_rot: torch.Tensor       # [3,3] columns
    eigvecs_trans: torch.Tensor     # [3,3]
    degenerate_rot: torch.Tensor    # [3] bool per eigen axis
    degenerate_trans: torch.Tensor  # [3]


def match(vmap_: vh.VoxelMap, points_b, q, t, map_cfg: vh.VoxelMapConfig):
    """Correspondence search: nearest valid plane for each point at pose
    (q, t). Returns (normal [N,3], mean [N,3], found [N])."""
    R = lie.quat_to_mat(q)
    return vh.query_planes(vmap_, points_b @ R.T + t, map_cfg)


def inlier_gates(residual, points_b, valid, found, cfg: GeometricConfig):
    """(inlier, in_dist, in_s) masks of the residual and s-score gates."""
    ar = torch.abs(residual)
    in_dist = ar <= cfg.max_p2p_dist
    pn = torch.sqrt(torch.linalg.vector_norm(points_b, dim=-1) + 1e-12)
    in_s = (1.0 - 0.9 * ar / pn) >= cfg.s_gate_min
    return valid & found & in_dist & in_s, in_dist, in_s


def four_dof_projection(H, b, R, g_dir):
    """Keep only yaw (about g_dir) of the rotation block: H <- P H P^T,
    b <- P b with P = diag(a a^T, I), a = R^T g_dir normalized."""
    a = R.T @ g_dir
    a = a / torch.clamp(torch.linalg.vector_norm(a), min=1e-9)
    P = torch.zeros((6, 6), dtype=H.dtype, device=H.device)
    P[:3, :3] = torch.outer(a, a)
    P[3:, 3:] = torch.eye(3, dtype=H.dtype, device=H.device)
    return P @ H @ P.T, P @ b


def linearize_with(matches, points_b, valid, q, t, cfg: GeometricConfig,
                   g_dir=None) -> ICPResult:
    """ICP linearization against fixed correspondences ``matches`` =
    (normal, mean, found) from :func:`match`."""
    dtype = points_b.dtype
    R = lie.quat_to_mat(q)
    p_w = points_b @ R.T + t
    normal, mean, found = matches
    r = torch.sum(normal * (p_w - mean), dim=-1)
    inlier, in_dist, in_s = inlier_gates(r, points_b, valid, found, cfg)

    ar = torch.abs(r)
    w_huber = torch.where(ar <= cfg.huber_delta, torch.ones_like(ar),
                          cfg.huber_delta / torch.clamp(ar, min=1e-12))
    w = torch.where(inlier, w_huber, torch.zeros_like(ar)) / cfg.sigma ** 2

    # Jacobian rows: dr/d(dR) = (p_B x R^T n)^T, dr/d(dt) = (R^T n)^T
    nR = normal @ R
    j_rot = lie.cross(points_b, nR)
    J = torch.cat([j_rot, nR], dim=-1)              # [N,6]
    H = (J * w[:, None]).T @ J
    b = J.T @ (w * r)

    counts = torch.stack([
        inlier.sum(), (valid & ~found).sum(), (valid & found & ~in_dist).sum(),
        (valid & found & in_dist & ~in_s).sum(),
    ]).to(torch.int32)

    # localizability: eigen-analysis of the unweighted J^T J blocks plus
    # per-point projections with the 0.5 cutoff
    m = inlier.to(dtype)
    Hrr = (j_rot * m[:, None]).T @ j_rot
    Htt = (nR * m[:, None]).T @ nR
    lam_r, V_r = eigh3(Hrr)
    lam_t, V_t = eigh3(Htt)
    strong_r = (torch.abs(j_rot @ V_r) >= cfg.loc_proj_cutoff) & inlier[:, None]
    strong_t = (torch.abs(nR @ V_t) >= cfg.loc_proj_cutoff) & inlier[:, None]
    cnt_r = strong_r.sum(0).to(torch.int32)
    cnt_t = strong_t.sum(0).to(torch.int32)
    mean_abs = torch.sum(ar * m) / torch.clamp(m.sum(), min=1.0)

    if cfg.use_4dof and g_dir is not None:
        H, b = four_dof_projection(H, b, R, g_dir)
    return ICPResult(H, b, counts[0], counts, mean_abs, cnt_r, cnt_t,
                     lam_r, lam_t, V_r, V_t,
                     cnt_r < cfg.loc_count_thresh_rot,
                     cnt_t < cfg.loc_count_thresh)


def linearize(vmap_: vh.VoxelMap, points_b, valid, q, t,
              map_cfg: vh.VoxelMapConfig, cfg: GeometricConfig,
              g_dir=None) -> ICPResult:
    """Fresh correspondence search + linearization. ``points_b`` [N,3] are
    deskewed body-frame points; tangent convention as ``se3_retract``."""
    m = match(vmap_, points_b, q, t, map_cfg)
    return linearize_with(m, points_b, valid, q, t, cfg, g_dir=g_dir)


class BinaryICPResult(NamedTuple):
    """Two-key scan-to-scan point-to-plane block, tangent layout
    [xi_source(6), xi_target(6)] (each [dR, dt] body-frame right)."""

    H: torch.Tensor               # [12,12]
    b: torch.Tensor               # [12]
    num_inlier: torch.Tensor      # int32 scalar
    status_counts: torch.Tensor   # [NUM_STATUS] int32
    mean_abs_res: torch.Tensor


def linearize_binary(vmap_t: vh.VoxelMap, points_src_b, valid, q_s, t_s,
                     q_t, t_t, map_cfg: vh.VoxelMapConfig,
                     cfg: GeometricConfig) -> BinaryICPResult:
    """Binary scan-to-scan ICP factor: source points registered against a
    voxel map in the TARGET state's body frame, constraining both poses.
    The unary factor is the case T_target = identity with a world-frame
    map (same gates and weights as :func:`linearize_with`).

    With delta = T_t^-1 T_s and y = dR p + dt (the source point in the
    target frame), the residual r = n.(y - mu) has the rows
      d r/d xi_s = [ p x (dR^T n),  dR^T n ]
      d r/d xi_t = [ n x y,        -n ]
    so a common rigid motion of both states is in the null space."""
    dtype = points_src_b.dtype
    qi, ti = lie.se3_inverse(q_t, t_t)
    q_d, t_d = lie.se3_compose(qi, ti, q_s, t_s)
    Rd = lie.quat_to_mat(q_d)
    y = points_src_b @ Rd.T + t_d
    normal, mean, found = vh.query_planes(vmap_t, y, map_cfg)
    r = torch.sum(normal * (y - mean), dim=-1)
    inlier, in_dist, in_s = inlier_gates(r, points_src_b, valid, found, cfg)

    ar = torch.abs(r)
    w_huber = torch.where(ar <= cfg.huber_delta, torch.ones_like(ar),
                          cfg.huber_delta / torch.clamp(ar, min=1e-12))
    w = torch.where(inlier, w_huber, torch.zeros_like(ar)) / cfg.sigma ** 2

    a = normal @ Rd                                 # rows are dR^T n
    J = torch.cat([lie.cross(points_src_b, a), a,   # source block
                   lie.cross(normal, y), -normal],  # target block
                  dim=-1)                           # [N,12]
    H = (J * w[:, None]).T @ J
    b = J.T @ (w * r)
    counts = torch.stack([
        inlier.sum(), (valid & ~found).sum(), (valid & found & ~in_dist).sum(),
        (valid & found & in_dist & ~in_s).sum(),
    ]).to(torch.int32)
    m = inlier.to(dtype)
    mean_abs = torch.sum(ar * m) / torch.clamp(m.sum(), min=1.0)
    return BinaryICPResult(H, b, counts[0], counts, mean_abs)


def _eigen_selector(res: ICPResult, keep_r, keep_t):
    dtype = res.H.dtype
    P_r = (res.eigvecs_rot * keep_r.to(dtype)[None, :]) @ res.eigvecs_rot.T
    P_t = (res.eigvecs_trans * keep_t.to(dtype)[None, :]) \
        @ res.eigvecs_trans.T
    P = torch.zeros((6, 6), dtype=dtype, device=res.H.device)
    P[:3, :3] = P_r
    P[3:, 3:] = P_t
    return P


def degenerate_selector(res: ICPResult):
    """6x6 selector keeping ONLY the degenerate eigen directions."""
    return _eigen_selector(res, res.degenerate_rot, res.degenerate_trans)


def degeneracy_projector(res: ICPResult):
    """6x6 projector zeroing GN-update components along degenerate eigen
    directions."""
    return _eigen_selector(res, ~res.degenerate_rot, ~res.degenerate_trans)
