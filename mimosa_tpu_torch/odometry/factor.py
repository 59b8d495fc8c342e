"""External-odometry relative-pose between factor.

Port of ``mimosa_tpu/odometry/factor.py``: consecutive external odometry
poses (e.g. VIO) become a body-frame relative-pose between factor on the
two window states they were declared at, gated on the host by the
D-optimality of the reported covariance, with fixed diagonal sigmas and the
T_B_S extrinsic conjugation. The [6,12] Jacobian comes from one
``torch.func.jacfwd``, as the JAX package takes it with ``jax.jacfwd``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from mimosa_tpu_torch.core import lie


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    sigma_rot: float = 0.02           # rad, per relative measurement
    sigma_trans: float = 0.05         # m
    max_d_optimality: float = 1e-2    # gate on reported pose covariance
    use_to_init: bool = False         # may this sensor trigger initialization
    # extrinsics T_B_S (odometry sensor in body)
    q_b_s: tuple = (1.0, 0.0, 0.0, 0.0)
    t_b_s: tuple = (0.0, 0.0, 0.0)


class BetweenResult(NamedTuple):
    H: torch.Tensor     # [12,12] over [pose_i(6), pose_j(6)]
    b: torch.Tensor     # [12]


def d_optimality(cov6: np.ndarray) -> float:
    """exp(mean(log(eig))) of the 6x6 pose covariance (host)."""
    w = np.linalg.eigvalsh(cov6)
    w = np.maximum(w, 1e-18)
    return float(np.exp(np.log(w).mean()))


@functools.lru_cache(maxsize=None)
def _extrinsics(q_b_s, t_b_s, device, dtype):
    """(q_bs, t_bs) on the device, made once per (value, device, dtype), as
    ``radar.factor`` makes its own."""
    return (torch.tensor(q_b_s, dtype=dtype, device=device),
            torch.tensor(t_b_s, dtype=dtype, device=device))


def relative_measurement(q_s_prev, t_s_prev, q_s_cur, t_s_cur,
                         cfg: OdometryConfig):
    """Body-frame relative pose from two sensor-frame odometry poses:
    T_meas = T_BS * (T_prev^-1 * T_cur) * T_BS^-1."""
    q_bs, t_bs = _extrinsics(cfg.q_b_s, cfg.t_b_s, t_s_prev.device,
                             t_s_prev.dtype)
    qi, ti = lie.se3_inverse(q_s_prev, t_s_prev)
    q_rel, t_rel = lie.se3_compose(qi, ti, q_s_cur, t_s_cur)
    q1, t1 = lie.se3_compose(q_bs, t_bs, q_rel, t_rel)
    q_sb, t_sb = lie.se3_inverse(q_bs, t_bs)
    return lie.se3_compose(q1, t1, q_sb, t_sb)


def linearize(q_i, p_i, q_j, p_j, q_meas, t_meas,
              cfg: OdometryConfig) -> BetweenResult:
    """Whitened between-factor block: r = Local(T_meas, T_i^-1 T_j)."""
    kw = dict(dtype=p_i.dtype, device=p_i.device)
    sig = torch.cat([torch.full((3,), cfg.sigma_rot, **kw),
                     torch.full((3,), cfg.sigma_trans, **kw)])

    def res_fn(xi):
        qi2, pi2 = lie.se3_retract(q_i, p_i, xi[:6])
        qj2, pj2 = lie.se3_retract(q_j, p_j, xi[6:])
        qinv, tinv = lie.se3_inverse(qi2, pi2)
        q_ij, t_ij = lie.se3_compose(qinv, tinv, qj2, pj2)
        r = lie.se3_local(q_meas, t_meas, q_ij, t_ij) / sig
        return r, r

    J, r = jacfwd(res_fn, has_aux=True)(torch.zeros(12, **kw))   # [6,12]
    return BetweenResult(J.T @ J, J.T @ r)
