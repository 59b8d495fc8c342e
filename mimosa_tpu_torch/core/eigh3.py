"""Closed-form eigendecomposition of symmetric 3x3 matrices, batched.

Port of ``mimosa_tpu/core/eigh3.py``: trigonometric eigenvalues plus
cross-product eigenvectors, elementwise work with no iteration. It feeds the
per-voxel plane fit and the ICP localizability analysis.
"""

from __future__ import annotations

import math

import torch

from mimosa_tpu_torch.core.lie import _unit_x_or_y, cross


def _det3(B):
    """Determinant of [..., 3, 3] by cofactor expansion (elementwise; no
    batched LU launch on the device)."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def eigvalsh3(A):
    """Eigenvalues of symmetric [..., 3, 3], ascending."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = _det3(B) / torch.clamp(2.0 * p * p * p, min=1e-30)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    lam = torch.stack([e3, e2, e1], dim=-1)
    # isotropic case: p ~ 0 -> all eigenvalues = q
    iso = p2 < 1e-28
    return torch.where(iso[..., None], torch.stack([q, q, q], dim=-1), lam)


def _eigvec_for(A, lam, fallback):
    """Eigenvector of symmetric A for eigenvalue lam: the largest cross
    product of two rows of (A - lam I); ``fallback`` where all vanish."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = cross(r0, r1)
    c02 = cross(r0, r2)
    c12 = cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None], c01,
        torch.where((n02 >= n12)[..., None], c02, c12))
    nbest = torch.maximum(torch.maximum(n01, n02), n12)
    v = best / torch.sqrt(torch.clamp(nbest, min=1e-30))[..., None]
    return torch.where((nbest > 1e-24)[..., None], v, fallback)


def _axis(k, A):
    """The k-th unit axis, broadcast like A's rows. Made on the device by a
    kernel: setting one element from a Python number copies it from
    pageable host memory, which a captured step cannot hold."""
    return torch.eye(3, dtype=A.dtype, device=A.device)[k].expand(
        A.shape[:-1])


def _any_orthogonal(v):
    u = cross(v, _unit_x_or_y(v))
    return u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)


def eigh3(A):
    """(eigvals ascending [..., 3], eigvecs [..., 3, 3]) with
    ``eigvecs[..., :, k]`` the k-th eigenvector."""
    lam = eigvalsh3(A)
    v0 = _eigvec_for(A, lam[..., 0], _axis(0, A))
    v2 = _eigvec_for(A, lam[..., 2], _axis(2, A))
    # make v2 orthogonal to v0, then complete the right-handed frame
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    v2n = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    v2 = torch.where(v2n > 1e-12, v2 / torch.clamp(v2n, min=1e-30),
                     _any_orthogonal(v0))
    v1 = cross(v2, v0)
    return lam, torch.stack([v0, v1, v2], dim=-1)


def smallest_eigvec3(A):
    """(eigenvalues ascending, unit eigenvector of the smallest) — the
    plane-fit primitive."""
    lam = eigvalsh3(A)
    return lam, _eigvec_for(A, lam[..., 0], _axis(2, A))
