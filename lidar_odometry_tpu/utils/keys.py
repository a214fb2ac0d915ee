"""Packed voxel keys and sorted-table primitives (the array-program
replacement for the reference's Robin-Hood voxel hash maps).

The reference keys voxels by integer coords hashed with a 63-bit Morton
code into `ankerl::unordered_dense` maps (reference src/database/
VoxelMap.h:152-183). Pointer-chasing hash maps do not map to fixed-shape
device programs; instead this module provides:

  * a 64-bit-equivalent packed key held as a PAIR of uint32 lanes
    (`hi`, `lo`), so all key math runs on 32-bit lanes and the package
    needs no `jax_enable_x64` on the hot path. A single uint64 key would
    also work on a GPU; switching is future work, and every table layout
    below (bucket rows, l1_meta) would change with it;
  * lexicographic sort of (hi, lo, *payload) via `jax.lax.sort`;
  * vectorized binary search (`searchsorted2`) over the sorted key arrays
    — the O(1) hash lookup of the reference becomes an O(log C) batched
    gather chain, which XLA vectorizes across all queries;
  * segment utilities for merge-by-key (the sorted-array version of
    hash-map accumulation).

Key layout: hi = bias32(iz), lo = bias16(ix) << 16 | bias16(iy).
This covers ix, iy in [-32768, 32767] voxels (±16 km at 0.5 m) and the
full int32 range in z. Ordering is z-major lexicographic; any total order
works for a sorted table (the reference's Morton order is a CPU
cache-locality device, not a semantic requirement). A host-side Morton
encoder is provided in `morton_np` for spatial shard partitioning and
parity tests against the reference bit-interleave
(reference VoxelMap.h:114-135).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "INVALID_HI", "INVALID_LO", "voxel_coords", "pack_key", "parent_coords",
    "key_lt", "key_eq", "sort_by_key", "searchsorted2", "segment_starts",
    "morton_np",
]

INVALID_HI = np.uint32(0xFFFFFFFF)
INVALID_LO = np.uint32(0xFFFFFFFF)

_BIAS32 = np.uint32(0x80000000)
_BIAS16 = np.int32(32768)


def voxel_coords(points: jax.Array, inv_voxel_size) -> jax.Array:
    """(..., 3) float points -> (..., 3) int32 voxel coords, floor semantics
    (reference VoxelMap.cpp:50-58)."""
    return jnp.floor(points * inv_voxel_size).astype(jnp.int32)


def pack_key(coords: jax.Array):
    """(..., 3) int32 coords -> (hi, lo) uint32 key pair."""
    ix, iy, iz = coords[..., 0], coords[..., 1], coords[..., 2]
    hi = (iz.astype(jnp.uint32) + _BIAS32)
    lx = ((ix + _BIAS16).astype(jnp.uint32) & jnp.uint32(0xFFFF))
    ly = ((iy + _BIAS16).astype(jnp.uint32) & jnp.uint32(0xFFFF))
    lo = (lx << jnp.uint32(16)) | ly
    return hi, lo


def unpack_key(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """(hi, lo) uint32 key pair -> (..., 3) int32 coords (inverse of pack_key)."""
    iz = (hi - _BIAS32).astype(jnp.int32)
    ix = (lo >> jnp.uint32(16)).astype(jnp.int32) - _BIAS16
    iy = (lo & jnp.uint32(0xFFFF)).astype(jnp.int32) - _BIAS16
    return jnp.stack([ix, iy, iz], axis=-1)


def parent_coords(coords: jax.Array, factor: int) -> jax.Array:
    """Integer floor-division parent key (reference VoxelMap.cpp:60-67)."""
    return jnp.floor_divide(coords, jnp.int32(factor))


def key_lt(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def key_eq(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


def sort_by_key(hi: jax.Array, lo: jax.Array, *payload: jax.Array):
    """Lexicographic sort by (hi, lo); payload arrays are permuted along.

    Multi-dimensional payloads are carried via the permutation of an index
    payload (lax.sort requires equal-shaped 1-D operands for keys).
    """
    n = hi.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    hi_s, lo_s, idx_s = jax.lax.sort((hi, lo, idx), num_keys=2)
    return (hi_s, lo_s) + tuple(p[idx_s] for p in payload)


def searchsorted2(table_hi: jax.Array, table_lo: jax.Array,
                  qhi: jax.Array, qlo: jax.Array) -> jax.Array:
    """Vectorized lower-bound binary search over a lexicographically sorted
    (hi, lo) table of static capacity C. Returns int32 insertion indices in
    [0, C]. Padding slots must hold (INVALID_HI, INVALID_LO), which sort to
    the end. ~log2(C) batched gathers; fully vectorized across queries.
    """
    c = table_hi.shape[0]
    n_steps = max(1, int(np.ceil(np.log2(max(c, 2)))) + 1)
    lo_b = jnp.zeros(qhi.shape, dtype=jnp.int32)
    hi_b = jnp.full(qhi.shape, c, dtype=jnp.int32)

    def body(_, state):
        lo_b, hi_b = state
        mid = (lo_b + hi_b) >> 1
        mhi = table_hi[mid]
        mlo = table_lo[mid]
        less = key_lt(mhi, mlo, qhi, qlo)
        lo_b = jnp.where(less, mid + 1, lo_b)
        hi_b = jnp.where(less, hi_b, mid)
        return lo_b, hi_b

    lo_b, _ = jax.lax.fori_loop(0, n_steps, body, (lo_b, hi_b))
    return lo_b


def segment_starts(hi_sorted: jax.Array, lo_sorted: jax.Array, valid: jax.Array):
    """For sorted keys, return (is_start, segment_id) where is_start marks the
    first occurrence of each distinct valid key and segment_id numbers the
    segments 0..S-1 (invalid entries get segment_id = their position's running
    id but is_start False; callers mask with `valid`)."""
    prev_hi = jnp.concatenate([hi_sorted[:1] ^ jnp.uint32(1), hi_sorted[:-1]])
    prev_lo = jnp.concatenate([lo_sorted[:1], lo_sorted[:-1]])
    is_new = ~key_eq(hi_sorted, lo_sorted, prev_hi, prev_lo)
    is_start = is_new & valid
    seg_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    return is_start, jnp.maximum(seg_id, 0)


# ---------------------------------------------------------------------------
# Host-side Morton utilities (numpy) — for shard partitioning and parity
# tests with the reference bit-interleave (reference VoxelMap.h:114-135).
# ---------------------------------------------------------------------------

def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_np(coords: np.ndarray) -> np.ndarray:
    """63-bit Morton code of int coords, with the reference's +2^20 bias and
    21-bit clamp (reference VoxelMap.h:124-135, VoxelKeyHash at :166-183)."""
    c = coords.astype(np.int64) + (1 << 20)
    c = np.clip(c, 0, (1 << 21) - 1).astype(np.uint64)
    return (_expand_bits_np(c[..., 0])
            | (_expand_bits_np(c[..., 1]) << np.uint64(1))
            | (_expand_bits_np(c[..., 2]) << np.uint64(2)))
