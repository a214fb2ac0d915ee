"""Legacy point-cloud filters (reference src/util/PointCloudUtils.h:462-638).

The reference defines three utility filters that its own pipeline never
calls — `VoxelGrid` (std::map weighted centroids), `CropBox`, and
`RangeFilter` — kept here for API completeness so a user of the
reference finds the same surface. Array-program style: fixed-shape masked arrays
instead of growing vectors (SURVEY.md §7); the hot-path downsampler is
ops/voxel_filter.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import keys as K

__all__ = ["voxel_grid_filter", "crop_box", "range_filter"]


@partial(jax.jit, static_argnames=("out_capacity",))
def voxel_grid_filter(points: jax.Array, mask: jax.Array, leaf_size,
                      out_capacity: int = None):
    """Weighted-centroid voxel downsample (reference VoxelGrid,
    PointCloudUtils.h:462-557). The reference's incremental
    weight/(weight+1) running average is mathematically the plain mean of
    the voxel's points — computed here as a sorted segment-mean.
    Returns (centroids (C, 3), valid (C,)) with C = out_capacity or N."""
    n = points.shape[0]
    cap = out_capacity or n
    inv = 1.0 / leaf_size
    coords = K.voxel_coords(points, inv)
    hi, lo = K.pack_key(coords)
    hi = jnp.where(mask, hi, K.INVALID_HI)
    lo = jnp.where(mask, lo, K.INVALID_LO)
    idx = jnp.arange(n, dtype=jnp.int32)
    s_hi, s_lo, s_idx = jax.lax.sort((hi, lo, idx), num_keys=2)
    s_ok = mask[s_idx]
    first = jnp.concatenate([jnp.ones((1,), bool),
                             ~((s_hi[1:] == s_hi[:-1])
                               & (s_lo[1:] == s_lo[:-1]))]) & s_ok
    gix = jnp.cumsum(first.astype(jnp.int32)) - 1
    data = jnp.concatenate([s_ok.astype(jnp.float32)[:, None],
                            jnp.where(s_ok[:, None], points[s_idx], 0.0)],
                           axis=1)
    seg = jax.ops.segment_sum(data, jnp.maximum(gix, 0), num_segments=cap,
                              indices_are_sorted=True)
    cnt = seg[:, 0]
    valid = cnt > 0.0
    centroids = seg[:, 1:] / jnp.maximum(cnt, 1.0)[:, None]
    return centroids, valid


@jax.jit
def crop_box(points: jax.Array, mask: jax.Array, min_pt, max_pt,
             negative: bool = False):
    """Axis-aligned box keep/reject (reference CropBox,
    PointCloudUtils.h:562-602). Returns the updated validity mask."""
    min_pt = jnp.asarray(min_pt)
    max_pt = jnp.asarray(max_pt)
    inside = jnp.all((points >= min_pt[None, :])
                     & (points <= max_pt[None, :]), axis=-1)
    return mask & (inside != negative)


@jax.jit
def range_filter(points: jax.Array, mask: jax.Array, min_range, max_range):
    """Euclidean range gate (reference RangeFilter,
    PointCloudUtils.h:607-638). Returns the updated validity mask."""
    r = jnp.linalg.norm(points, axis=-1)
    return mask & (r >= min_range) & (r <= max_range)
