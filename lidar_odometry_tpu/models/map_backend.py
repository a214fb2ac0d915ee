"""Map backends behind the Estimator front door.

The reference has exactly ONE map implementation (a single-process hash
table, reference src/database/VoxelMap.{h,cpp}) and ONE front door
(`Estimator::process_frame`, reference src/processing/Estimator.cpp:116).
This system keeps the single front door but lets it run against either:

  * `SingleChipMapBackend` — the plain device-resident map
    (ops/voxel_map.py) + single-chip ICP (ops/icp.py); or
  * `ShardedMapBackend` — the parent-hash-sharded map over a
    `jax.sharding.Mesh` (parallel/sharded_map.py): per-shard O(scan/S)
    keyframe updates with zero table movement, full-parity distributed
    ICP (sigma/6 + PKO + robust weights via psum/all_gather), and the
    all_gather rebuild on loop-closure corrections. BASELINE config 5
    ("multi-host KITTI, map sharded, distributed Schur PGO") runs the
    whole SLAM pipeline through this backend.

Each backend exposes the four device-side map operations the orchestrator
needs; everything else in `Estimator` (keyframe bookkeeping, loop-closure
detection, pose graph, background worker) is backend-agnostic. Loop-
closure ICP intentionally stays single-device in both backends: it runs
against a matched KEYFRAME's feature cloud, never against the voxel map
(reference IterativeClosestPointOptimizer.cpp:40-75 deep-copies the
keyframes for exactly this isolation).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops import icp as icp_ops
from ..ops import voxel_map as vm

__all__ = ["SingleChipMapBackend", "ShardedMapBackend"]


class SingleChipMapBackend:
    """The default backend: one device holds the whole map."""

    name = "single"

    def __init__(self, config):
        self.cfg = config

    def empty(self) -> vm.VoxelMapState:
        return vm.empty_map(self.cfg.map_l0_capacity, self.cfg.map_l1_capacity)

    def icp_optimize(self, state, pts, mask, T_init, pko_consts, icp_cfg):
        return icp_ops.icp_optimize(state, pts, mask, T_init, pko_consts,
                                    icp_cfg)

    def update(self, state, world_pts, mask, sensor_pos, max_distance,
               evict_enabled=None):
        return vm.update_map(
            state, world_pts, mask, sensor_pos, max_distance,
            voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor(),
            compute_surfels=self.cfg.use_surfel_correspondence,
            evict_enabled=evict_enabled)

    def rehash(self, state, correction):
        return vm.transform_and_rehash(
            state, jnp.asarray(correction),
            voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor())


# jit wrappers over the shard_map'd ops: mesh / geometry / ICPConfig are
# static (hashable), so each (mesh, config) pair compiles once and every
# per-frame call is a cached dispatch.

@partial(jax.jit, static_argnames=("mesh", "cfg", "mesh_axis"))
def _sharded_icp_jit(state, pts, mask, T_init, mesh, cfg, pko_consts,
                     mesh_axis):
    from ..parallel import sharded_map as sm
    return sm.sharded_icp_optimize(state, pts, mask, T_init, mesh, cfg,
                                   pko_consts, mesh_axis)


@partial(jax.jit, static_argnames=("mesh", "voxel_size",
                                   "planarity_threshold", "hierarchy_factor",
                                   "compute_surfels", "mesh_axis"))
def _sharded_update_jit(state, pts, mask, sensor_pos, max_distance, mesh, *,
                        voxel_size, planarity_threshold, hierarchy_factor,
                        compute_surfels, mesh_axis):
    from ..parallel import sharded_map as sm
    return sm.sharded_update_map(
        state, pts, mask, sensor_pos, max_distance, mesh,
        voxel_size=voxel_size, planarity_threshold=planarity_threshold,
        hierarchy_factor=hierarchy_factor, compute_surfels=compute_surfels,
        mesh_axis=mesh_axis)


@partial(jax.jit, static_argnames=("mesh", "voxel_size",
                                   "planarity_threshold", "hierarchy_factor",
                                   "mesh_axis"))
def _sharded_rehash_jit(state, T, mesh, *, voxel_size, planarity_threshold,
                        hierarchy_factor, mesh_axis):
    from ..parallel import sharded_map as sm
    return sm.sharded_transform_and_rehash(
        state, T, mesh, voxel_size=voxel_size,
        planarity_threshold=planarity_threshold,
        hierarchy_factor=hierarchy_factor, mesh_axis=mesh_axis)


class ShardedMapBackend:
    """Spatially-sharded map over `mesh_axis` of a device mesh.

    Capacities are TOTAL across shards (config.map_l0_capacity /
    map_l1_capacity must be divisible by the axis size). Odometry ICP is
    the full-parity distributed loop (parallel/sharded_map.robust_icp_loop);
    the keyframe update runs shard-locally on each shard's owned O(scan/S)
    subset; a PGO correction triggers the all_gather rebuild. The surfel
    correspondence mode is required — the sharded lookup answers through
    the parent-hash owner, which is how surfel queries route (the grid-kNN
    KD-tree mode would need neighbor-shard halos; use the single-chip
    backend for MID360-style indoor configs).
    """

    name = "sharded"

    def __init__(self, config, mesh, mesh_axis: str = "map",
                 update_batch: int = None):
        if not config.use_surfel_correspondence:
            raise ValueError(
                "ShardedMapBackend requires use_surfel_correspondence=True")
        s = mesh.shape[mesh_axis]
        if config.map_l1_capacity % s:
            raise ValueError(
                f"map_l1_capacity {config.map_l1_capacity} not divisible by "
                f"mesh axis '{mesh_axis}' size {s}")
        self.cfg = config
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        # Batching K keyframe updates into one dispatch amortizes the
        # per-op latency floors that dominate the per-shard update at
        # small O(scan/S) shapes, where fixed small-op latency outweighs
        # the per-shard work at high shard counts. The map lags lookups
        # by at most K-1 keyframes; evictions defer the same way they
        # already do under the bounded caps (delayed, never lost).
        self.update_batch = (update_batch if update_batch is not None
                             else getattr(config, "sharded_update_batch", 1))
        self._pend = []       # [(world_pts, mask, sensor)] device arrays
        self._n_updates = 0   # first K dispatch immediately (bootstrap:
        #                       deferring the FIRST keyframes starves ICP
        #                       of any map at all)

    def empty(self) -> vm.VoxelMapState:
        from ..parallel import sharded_map as sm
        return sm.sharded_empty_map(self.cfg.map_l0_capacity,
                                    self.cfg.map_l1_capacity,
                                    self.mesh, self.mesh_axis)

    def icp_optimize(self, state, pts, mask, T_init, pko_consts, icp_cfg):
        return _sharded_icp_jit(state, pts, mask, T_init, self.mesh,
                                icp_cfg, pko_consts, self.mesh_axis)

    def _dispatch_update(self, state, world_pts, mask, sensor_pos,
                         max_distance):
        return _sharded_update_jit(
            state, world_pts, mask, sensor_pos,
            jnp.asarray(max_distance, jnp.float32), self.mesh,
            voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor(),
            compute_surfels=self.cfg.use_surfel_correspondence,
            mesh_axis=self.mesh_axis)

    def update(self, state, world_pts, mask, sensor_pos, max_distance,
               evict_enabled=None):
        # evict_enabled is accepted for front-door parity; the sharded
        # update batches keyframes (K per dispatch) so its eviction is
        # already amortized K-fold.
        del evict_enabled
        self._n_updates += 1
        if (self.update_batch <= 1
                or self._n_updates <= self.update_batch):
            return self._dispatch_update(state, world_pts, mask, sensor_pos,
                                         max_distance)
        self._pend.append((jnp.asarray(world_pts), jnp.asarray(mask),
                           jnp.asarray(sensor_pos)))
        if len(self._pend) < self.update_batch:
            return state
        return self._flush_pending(state, max_distance)

    def _flush_pending(self, state, max_distance):
        k = self.update_batch
        pend = self._pend + [(self._pend[0][0],
                              jnp.zeros_like(self._pend[0][1]),
                              self._pend[-1][2])] * (k - len(self._pend))
        sensor = pend[-1][2]
        self._pend = []
        pts = jnp.concatenate([p for p, _, _ in pend])
        msk = jnp.concatenate([m for _, m, _ in pend])
        # eviction radius is taken from the NEWEST keyframe's sensor
        # position; earlier keyframes' evictions defer exactly as the
        # bounded caps already defer them (recomputed from live
        # centroids every update — delayed, never lost)
        return self._dispatch_update(state, pts, msk, sensor, max_distance)

    def flush(self, state):
        """Insert any pending batched keyframes now (call before reading
        the map content, checkpointing, or applying a PGO correction)."""
        if not self._pend:
            return state
        return self._flush_pending(state, self.cfg.max_range * 1.2)

    def rehash(self, state, correction):
        # pending inserts are in the PRE-correction world frame — they
        # must land before the transform
        state = self.flush(state)
        return _sharded_rehash_jit(
            state, jnp.asarray(correction), self.mesh,
            voxel_size=self.cfg.map_voxel_size,
            planarity_threshold=self.cfg.surfel_planarity_threshold,
            hierarchy_factor=self.cfg.derived_hierarchy_factor(),
            mesh_axis=self.mesh_axis)
