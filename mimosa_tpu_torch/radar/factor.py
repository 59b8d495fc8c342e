"""Radar radial-speed (Doppler) factor, batched over targets.

Port of ``mimosa_tpu/radar/factor.py``: per radar target with unit bearing
``d`` (radar frame) and measured radial speed ``vr``,

    v_R = R_BR^T (R_WB^T v_W + (omega - b_g) x t_BR)
    e   = -(d . v_R) - vr

on the [dR, dv, dbg] tangent block of one window state, with a Cauchy
weight (c = 2.3849). The Jacobian comes from one ``torch.func.jacfwd`` over
the 9-dof tangent, as the JAX package takes it with ``jax.jacfwd``. The JAX
package has no Pallas kernel here (XLA fuses it), so this stays plain
torch inside the captured step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd

from mimosa_tpu_torch.core import lie


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    sigma: float = 0.15               # radial speed noise [m/s]
    cauchy_c: float = 2.3849
    # target filters
    min_snr_db: float = 5.0
    min_range: float = 0.5
    max_range: float = 60.0
    max_azimuth: float = 0.9          # rad, cone half-angle
    max_elevation: float = 0.9
    use_to_init: bool = False         # may this sensor trigger initialization
    # extrinsics T_B_R
    q_b_r: tuple = (1.0, 0.0, 0.0, 0.0)
    t_b_r: tuple = (0.0, 0.0, 0.0)


class DopplerResult(NamedTuple):
    H: torch.Tensor           # [9,9] over [dR, dv, dbg]
    b: torch.Tensor           # [9]
    num_inlier: torch.Tensor
    mean_abs_res: torch.Tensor


@functools.lru_cache(maxsize=None)
def _extrinsics(q_b_r, t_b_r, device, dtype):
    """(q_br, t_br) on the device, made once per (value, device, dtype):
    a captured step holds no host copy, and the first call of a step
    variant (its eager warm-up) makes them."""
    return (torch.tensor(q_b_r, dtype=dtype, device=device),
            torch.tensor(t_b_r, dtype=dtype, device=device))


def residuals(q_wb, v_w, bg, omega_b, dirs_r, doppler, cfg: RadarConfig):
    """e [N] for targets with unit bearings dirs_r [N,3] (radar frame) and
    measured radial speeds doppler [N]. omega_b: gyro measurement [3]."""
    q_br, t_br = _extrinsics(cfg.q_b_r, cfg.t_b_r, dirs_r.device,
                             dirs_r.dtype)
    v_b = lie.quat_rotate(lie.quat_conj(q_wb), v_w)
    v_lever = lie.cross(omega_b - bg, t_br)
    v_r = lie.quat_rotate(lie.quat_conj(q_br), v_b + v_lever)
    return -(dirs_r @ v_r) - doppler


def linearize(q_wb, v_w, bg, omega_b, dirs_r, doppler, valid,
              cfg: RadarConfig) -> DopplerResult:
    """The whitened, Cauchy-weighted 9x9 Hessian block."""
    z9 = torch.zeros(9, dtype=v_w.dtype, device=v_w.device)

    def res_fn(xi):
        q2 = lie.quat_mul(q_wb, lie.exp_so3(xi[:3]))
        r = residuals(q2, v_w + xi[3:6], bg + xi[6:9], omega_b, dirs_r,
                      doppler, cfg)
        return r, r

    J, r = jacfwd(res_fn, has_aux=True)(z9)          # [N,9], [N]
    w_rob = 1.0 / (1.0 + (r / (cfg.cauchy_c * cfg.sigma)) ** 2)
    w = torch.where(valid, w_rob, torch.zeros_like(w_rob)) / (cfg.sigma ** 2)
    H = torch.einsum("ni,nj,n->ij", J, J, w)
    b = torch.einsum("ni,n->i", J, w * r)
    m = valid.to(r.dtype)
    return DopplerResult(H, b, valid.to(torch.int32).sum(),
                         torch.sum(torch.abs(r) * m)
                         / torch.clamp(torch.sum(m), min=1.0))


def filter_targets(points_r, snr_db, cfg: RadarConfig):
    """Per-target validity gates (NaN, SNR, range, azimuth and elevation
    cones). Returns (unit dirs, ranges, valid). NaN rows are sanitized
    before any arithmetic: 0 * NaN would poison the masked Hessian sums,
    and their tangents under ``jacfwd`` too."""
    finite = torch.isfinite(points_r).all(-1)
    points_r = torch.where(finite[:, None], points_r,
                           torch.ones_like(points_r))
    rng = torch.sqrt(torch.sum(points_r * points_r, dim=-1))
    safe = torch.clamp(rng, min=1e-6)
    dirs = points_r / safe[:, None]
    az = torch.atan2(points_r[:, 1], points_r[:, 0])
    el = torch.asin(torch.clamp(points_r[:, 2] / safe, -1.0, 1.0))
    valid = (finite & (snr_db >= cfg.min_snr_db) & (rng >= cfg.min_range)
             & (rng <= cfg.max_range) & (torch.abs(az) <= cfg.max_azimuth)
             & (torch.abs(el) <= cfg.max_elevation))
    return dirs, rng, valid
