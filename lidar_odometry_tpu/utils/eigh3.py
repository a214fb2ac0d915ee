"""Closed-form eigendecomposition of symmetric 3x3 matrices, batched.

The reference fits surfel planes with Eigen::JacobiSVD on each 3x3
covariance (reference src/database/VoxelMap.cpp:239-242) and plane fits
with JacobiSVD of the centered neighbor matrix
(IterativeClosestPointOptimizer.cpp:744-746). A batched iterative SVD is
a poor fit for millions of tiny matrices inside one fused program; for
symmetric PSD matrices the singular values equal the eigenvalues and the
singular vectors are eigenvectors, so we use the analytic trigonometric
eigenvalue formula plus cross-product eigenvectors — pure elementwise
math that vectorizes across the batch.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["eigh3", "smallest_eigenvector", "plane_from_points"]


def _eigvals3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending (l0 <= l1 <= l2)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    p_safe = jnp.where(p < 1e-20, 1.0, p)

    b00, b11, b22 = (a00 - q) / p_safe, (a11 - q) / p_safe, (a22 - q) / p_safe
    b01, b02, b12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    l2 = q + 2.0 * p * jnp.cos(phi)
    l0 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    l1 = 3.0 * q - l0 - l2
    near_diag = p < 1e-20
    d = jnp.stack([a00, a11, a22], axis=-1)
    d_sorted = jnp.sort(d, axis=-1)
    lam = jnp.stack([l0, l1, l2], axis=-1)
    return jnp.where(near_diag[..., None], d_sorted, lam)


def _eigvec_for(A, lam):
    """Eigenvector for eigenvalue lam of symmetric (..., 3, 3): the null
    direction of (A - lam I), taken as the largest cross product of its
    rows (robust row pivoting)."""
    I = jnp.eye(3, dtype=A.dtype)
    M = A - lam[..., None, None] * I
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    norms = jnp.stack([n01, n02, n12], axis=-1)
    best = jnp.argmax(norms, axis=-1)
    cand = jnp.stack([c01, c02, c12], axis=-2)  # (..., 3cand, 3)
    v = jnp.take_along_axis(cand, best[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    degenerate = nrm[..., 0] < 1e-20
    v = jnp.where(degenerate[..., None],
                  jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dtype=A.dtype), v.shape),
                  v / jnp.where(nrm < 1e-20, 1.0, nrm))
    return v


def eigh3(A):
    """Return (eigvals ascending (...,3), smallest-eigval eigenvector (...,3))."""
    lam = _eigvals3(A)
    v = _eigvec_for(A, lam[..., 0])
    return lam, v


def smallest_eigenvector(A):
    return _eigvec_for(A, _eigvals3(A)[..., 0])


def plane_from_points(pts, mask):
    """Masked plane fit of (..., K, 3) points: returns (normal, centroid,
    planarity) where planarity = lam_min / (lam_max + 1e-6), matching the
    reference's sigma2/sigma0 surfel score (VoxelMap.cpp:240-242).

    The covariance is the mean outer product of centered points over the
    valid entries — identical to the reference accumulation
    (VoxelMap.cpp:231-236).
    """
    m = mask[..., None].astype(pts.dtype)
    cnt = jnp.maximum(jnp.sum(m, axis=-2), 1.0)
    centroid = jnp.sum(pts * m, axis=-2) / cnt
    d = (pts - centroid[..., None, :]) * m
    cov = jnp.einsum("...ki,...kj->...ij", d, d) / cnt[..., None]
    lam, normal = eigh3(cov)
    planarity = lam[..., 0] / (lam[..., 2] + 1e-6)
    return normal, centroid, planarity
