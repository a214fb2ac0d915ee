"""Coarse loop-closure pre-alignment: BEV phase correlation + Iris yaw.

The reference's loop ICP searches correspondences with an UNBOUNDED
KD-tree (reference IterativeClosestPointOptimizer.cpp:465-585), so loops
with many metres of drift still find matches. This loop ICP uses a
bounded grid search (+-2 cells of 2 m bins, ops/icp.icp_optimize_loop) —
fast and fixed-shape, but blind beyond ~5 m of initial misalignment,
exactly where loop closure matters most (round-2 VERDICT weak item 5).

This module restores the envelope with a two-stage coarse pre-alignment
executed once per loop candidate (rare path):

  1. YAW from the Iris bias: the descriptor comparison already estimates
     the column shift delta ~ yaw_query - yaw_matched in 1-degree bins
     (ops/iris._compare_one; the reference computes the same bias and
     ignores it, LidarIris.cpp:26-37). The matched keyframe's (older,
     better-anchored) pose is trusted: the query's corrected yaw is
     yaw_matched + delta.
  2. TRANSLATION from bird's-eye-view phase correlation: both keyframe
     clouds are rasterized into (G, G) occupancy grids around the matched
     position and the x-y offset is the argmax of the normalized cross-
     power spectrum — one small FFT, O(G^2 log G), robust to partial
     overlap and independent of the drift magnitude up to +-G/2 cells.

The fine ICP then starts inside its search envelope regardless of the
accumulated drift.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["bev_translation_offset", "prealign_pose"]


@partial(jax.jit, static_argnames=("grid", "bin_size"))
def bev_translation_offset(pts_a: jax.Array, mask_a: jax.Array,
                           pts_b: jax.Array, mask_b: jax.Array,
                           center: jax.Array, *, grid: int = 128,
                           bin_size: float = 1.0) -> jax.Array:
    """x-y translation (2,) f32 that moves world cloud A onto world cloud
    B, estimated by phase correlation of (grid, grid) binary occupancy
    images centred at `center`. Covers offsets up to +-grid/2 * bin_size.
    """
    half = grid // 2

    def img(p, m):
        ij = jnp.floor((p[:, :2] - center[None, :2]) / bin_size).astype(
            jnp.int32) + half
        ok = m & jnp.all((ij >= 0) & (ij < grid), axis=1)
        flat = jnp.where(ok, ij[:, 0] * grid + ij[:, 1], grid * grid)
        occ = jnp.zeros((grid * grid,), jnp.int32).at[flat].add(
            1, mode="drop")
        return (occ > 0).astype(jnp.float32).reshape(grid, grid)

    fa = jnp.fft.fft2(img(pts_a, mask_a).astype(jnp.complex64))
    fb = jnp.fft.fft2(img(pts_b, mask_b).astype(jnp.complex64))
    cross = fb * jnp.conj(fa)
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    corr = jnp.real(jnp.fft.ifft2(cross))
    flat = jnp.argmax(corr.reshape(-1)).astype(jnp.int32)
    di, dj = flat // grid, flat % grid
    di = jnp.where(di >= half, di - grid, di)
    dj = jnp.where(dj >= half, dj - grid, dj)
    return jnp.stack([di, dj]).astype(jnp.float32) * bin_size


def _yaw_of(R: np.ndarray) -> float:
    return float(np.arctan2(R[1, 0], R[0, 0]))


def prealign_pose_jnp(current_pose, matched_pose, bias_deg,
                      query_cloud, query_mask, matched_world, matched_mask,
                      *, grid: int = 128, bin_size: float = 1.0):
    """Device (traceable) version of prealign_pose — composed into the
    fused loop-closure dispatch (ops/icp.loop_closure_solve) so the whole
    prealign + ICP pipeline costs one device-to-host fetch. bias_deg is a
    traced scalar."""
    delta = (jnp.mod(bias_deg + 180.0, 360.0) - 180.0) * (jnp.pi / 180.0)
    yaw_m = jnp.arctan2(matched_pose[1, 0], matched_pose[0, 0])
    yaw_c = jnp.arctan2(current_pose[1, 0], current_pose[0, 0])
    dyaw = yaw_m + delta - yaw_c
    dyaw = jnp.mod(dyaw + jnp.pi, 2.0 * jnp.pi) - jnp.pi
    c, s = jnp.cos(dyaw), jnp.sin(dyaw)
    Rz = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    Rz = Rz.at[0, 0].set(c).at[0, 1].set(-s).at[1, 0].set(s).at[1, 1].set(c)
    R_init = Rz @ current_pose[:3, :3]
    t_init = current_pose[:3, 3]
    q_world = query_cloud @ R_init.T + t_init[None, :]
    off = bev_translation_offset(
        q_world, query_mask, matched_world, matched_mask,
        matched_pose[:3, 3], grid=grid, bin_size=bin_size)
    t_init = t_init.at[:2].add(off)
    T_init = jnp.eye(4, dtype=jnp.float32)
    T_init = T_init.at[:3, :3].set(R_init).at[:3, 3].set(t_init)
    return T_init


def prealign_pose(current_pose: np.ndarray, matched_pose: np.ndarray,
                  bias_deg: int, query_cloud, query_mask,
                  matched_world, matched_mask, *, grid: int = 128,
                  bin_size: float = 1.0) -> np.ndarray:
    """Coarse world-pose initializer for the loop ICP. Host orchestration
    (one device dispatch for the BEV correlation); returns a corrected
    (4, 4) float32 world pose for the query keyframe."""
    # 1) yaw: trust the matched pose + the Iris column shift
    delta = float(((bias_deg + 180.0) % 360.0) - 180.0) * np.pi / 180.0
    target_yaw = _yaw_of(matched_pose[:3, :3]) + delta
    dyaw = target_yaw - _yaw_of(current_pose[:3, :3])
    dyaw = (dyaw + np.pi) % (2.0 * np.pi) - np.pi
    c, s = np.cos(dyaw), np.sin(dyaw)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    T_init = current_pose.astype(np.float32).copy()
    T_init[:3, :3] = Rz @ T_init[:3, :3]

    # 2) x-y translation: BEV phase correlation of the yaw-corrected query
    #    cloud against the matched keyframe's world cloud
    q_world = (np.asarray(query_cloud) @ T_init[:3, :3].T
               + T_init[:3, 3][None, :])
    off = np.asarray(bev_translation_offset(
        jnp.asarray(q_world), jnp.asarray(query_mask),
        jnp.asarray(matched_world), jnp.asarray(matched_mask),
        jnp.asarray(matched_pose[:3, 3]), grid=grid, bin_size=bin_size))
    T_init[0, 3] += off[0]
    T_init[1, 3] += off[1]
    return T_init
