"""Batched SO(3)/SE(3) Lie-group operations in pure jnp.

Semantics follow the reference implementation (reference:
src/util/MathUtils.cpp:23-174) including:
  * twist ordering [trans, rot] for SE(3) Exp/Log
    (src/util/MathUtils.h:109-123),
  * Rodrigues Exp with small-angle branch (MathUtils.cpp:23-39),
  * Log with the theta ~ pi special case (MathUtils.cpp:41-84),
  * rotation-matrix projection onto SO(3) on construction
    (MathUtils.cpp:86-99) — here via a Newton orthogonalization
    iteration, which converges to the same nearest rotation for
    near-orthogonal inputs and avoids a general SVD inside jit.

All functions are shape-polymorphic over leading batch dimensions and
preserve the input dtype (float32 on the device hot path; float64 available
for the pose-graph solver).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "hat", "vee", "so3_exp", "so3_log", "so3_project", "so3_project_svd",
    "se3_exp", "se3_log", "se3_matrix", "se3_rt", "se3_inv", "se3_mul",
    "se3_identity", "se3_from_exp_rt", "transform_points",
]


def _eps(dtype) -> float:
    # reference: src/util/MathUtils.h:40-41 (kEps=1e-6f, kEpsD=1e-10)
    return 1e-6 if jnp.dtype(dtype) == jnp.float32 else 1e-10


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of (..., 3) vectors (reference MathUtils.h:264)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def vee(S: jax.Array) -> jax.Array:
    """Inverse of hat for (..., 3, 3) skew matrices (reference MathUtils.h:270)."""
    return jnp.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], axis=-1)


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula, (..., 3) -> (..., 3, 3). reference MathUtils.cpp:23-39."""
    dtype = w.dtype
    eps = _eps(dtype)
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    small = theta < eps
    # Safe axis for the large-angle branch.
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    K = hat(w / theta_safe[..., 0])
    I = jnp.broadcast_to(jnp.eye(3, dtype=dtype), K.shape)
    big = I + jnp.sin(theta) * K + (1.0 - jnp.cos(theta)) * (K @ K)
    return jnp.where(small, I + hat(w), big)


def so3_log(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 3) axis-angle. reference MathUtils.cpp:41-84.

    Implements all three branches: small angle, generic, and theta ~ pi
    (diagonal-pivot axis extraction with sign fix). Deviation from the
    reference: theta comes from atan2(|vee(R - R^T)|/2, (tr-1)/2) instead
    of arccos((tr-1)/2) — arccos is catastrophically conditioned near pi
    and the reference silently returns near-zero vectors for rotations in
    a window below pi; atan2 agrees to machine precision elsewhere.
    """
    dtype = R.dtype
    eps = _eps(dtype)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)

    skew_part = vee(R - jnp.swapaxes(R, -1, -2))  # 2*sin(theta)*axis
    sin_theta = 0.5 * jnp.linalg.norm(skew_part, axis=-1)
    theta = jnp.arctan2(sin_theta, cos_theta)

    # Generic branch.
    sin_safe = jnp.where(jnp.abs(sin_theta) < eps, jnp.ones_like(sin_theta), sin_theta)
    generic = (theta / (2.0 * sin_safe))[..., None] * skew_part

    # theta ~ pi branch: pick the largest diagonal element as pivot.
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    max_idx = jnp.argmax(diag, axis=-1)
    d_max = jnp.take_along_axis(diag, max_idx[..., None], axis=-1)[..., 0]
    axis_pivot = jnp.sqrt(jnp.maximum((d_max + 1.0) * 0.5, 0.0))
    axis_pivot_safe = jnp.where(axis_pivot < eps, jnp.ones_like(axis_pivot), axis_pivot)
    # axis[i] = R[max_idx, i] / (2*axis[max_idx]) for i != max_idx
    row = jnp.take_along_axis(R, max_idx[..., None, None].repeat(3, axis=-1), axis=-2)[..., 0, :]
    axis = row / (2.0 * axis_pivot_safe[..., None])
    one_hot = jax.nn.one_hot(max_idx, 3, dtype=dtype)
    axis = axis * (1.0 - one_hot) + axis_pivot[..., None] * one_hot
    # Sign fix against the skew part (reference MathUtils.cpp:72-78).
    dot = jnp.sum(axis * (skew_part * 0.5), axis=-1)
    axis = jnp.where((dot < 0)[..., None], -axis, axis)
    near_pi = axis * theta[..., None]

    small = theta < eps
    at_pi = jnp.abs(sin_theta) < eps
    out = jnp.where(at_pi[..., None], near_pi, generic)
    return jnp.where(small[..., None], vee(R - jnp.eye(3, dtype=dtype)), out)


def so3_project(R: jax.Array, iters: int = 3) -> jax.Array:
    """Project a near-rotation onto SO(3).

    The reference projects via SVD on every SE3-from-matrix construction
    (MathUtils.cpp:86-99). For matrices already close to a rotation the
    Newton iteration  R <- 1.5 R - 0.5 R R^T R  converges quadratically to
    the same nearest orthogonal factor; 3 iterations reach machine
    precision and compile to plain 3x3 matmuls.
    """
    for _ in range(iters):
        R = 1.5 * R - 0.5 * (R @ jnp.swapaxes(R, -1, -2) @ R)
    return R


def so3_project_svd(R: jax.Array) -> jax.Array:
    """Exact SVD projection (reference MathUtils.cpp:86-99), with the
    determinant fix for reflections. Used for testing and for host-side
    normalization where a reflection could plausibly occur."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    U = U.at[..., :, 2].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    return U @ Vt


def _so3_left_jacobian(phi: jax.Array) -> jax.Array:
    """V matrix of SE(3) Exp (reference MathUtils.cpp:118-144)."""
    dtype = phi.dtype
    eps = _eps(dtype)
    theta = jnp.linalg.norm(phi, axis=-1)
    small = theta < eps
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    ph = hat(phi)
    t2 = theta_safe * theta_safe
    a = (1.0 - jnp.cos(theta_safe)) / t2
    b = (theta_safe - jnp.sin(theta_safe)) / (t2 * theta_safe)
    I = jnp.broadcast_to(jnp.eye(3, dtype=dtype), ph.shape)
    V = I + a[..., None, None] * ph + b[..., None, None] * (ph @ ph)
    return jnp.where(small[..., None, None], I, V)


def _so3_left_jacobian_inv(phi: jax.Array) -> jax.Array:
    """V^{-1} of SE(3) Log (reference MathUtils.cpp:147-174)."""
    dtype = phi.dtype
    eps = _eps(dtype)
    theta = jnp.linalg.norm(phi, axis=-1)
    small = theta < eps
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    ph = hat(phi)
    t2 = theta_safe * theta_safe
    st = jnp.sin(theta_safe)
    ct = jnp.cos(theta_safe)
    st_safe = jnp.where(jnp.abs(st) < eps, jnp.ones_like(st), st)
    coeff = (2.0 * st_safe - theta_safe * (1.0 + ct)) / (2.0 * t2 * st_safe)
    I = jnp.broadcast_to(jnp.eye(3, dtype=dtype), ph.shape)
    Vinv = I - 0.5 * ph + coeff[..., None, None] * (ph @ ph)
    return jnp.where(small[..., None, None], I, Vinv)


def se3_exp(xi: jax.Array) -> jax.Array:
    """SE(3) exponential, twist ordered [trans(3), rot(3)] -> (..., 4, 4).

    reference MathUtils.cpp:118-144 (convention at MathUtils.h:109-123).
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return se3_matrix(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """(..., 4, 4) -> [trans(3), rot(3)] twist. reference MathUtils.cpp:147-174."""
    R, t = se3_rt(T)
    phi = so3_log(R)
    rho = (_so3_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def se3_matrix(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble (..., 4, 4) from rotation and translation."""
    dtype = R.dtype
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_rt(T: jax.Array):
    return T[..., :3, :3], T[..., :3, 3]


def se3_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)


def se3_inv(T: jax.Array) -> jax.Array:
    R, t = se3_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return se3_matrix(Rt, -(Rt @ t[..., None])[..., 0])


def se3_mul(A: jax.Array, B: jax.Array) -> jax.Array:
    return A @ B


def se3_from_exp_rt(dt: jax.Array, dw: jax.Array) -> jax.Array:
    """ICP retraction increment: SE3(SO3::Exp(dw), dt) — note: NO V matrix
    on the translation, matching the reference GN update exactly
    (IterativeClosestPointOptimizer.cpp:425-434)."""
    return se3_matrix(so3_exp(dw), dt)


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (4,4) (or batched) transform to (..., N, 3) points."""
    R, t = se3_rt(T)
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]
