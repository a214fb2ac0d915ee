"""Multi-chip odometry step: the full per-scan update jitted over a 2-D
device mesh.

Axes (SURVEY.md §2.4):
  * `data` — independent sequences batched for throughput (odometry within
    a sequence is inherently serial, so cross-sequence batching is where
    device-level scans/s comes from);
  * `map`  — parent-hash shards of each sequence's voxel map (see
    parallel/sharded_map.py): every shard is a self-contained single-chip
    map owning the voxels whose parent cell hashes to it.

One step = ICP iterations (per-shard surfel gather, psum of the 6x6
normal equations over `map`) -> keyframe map update executed SHARD-LOCALLY
on the owned subset of the scan. Per-keyframe communication is the
O(scan) broadcast of points plus the psum'd 6x6 systems — no table
movement (the round-1 version all-gathered every slot table per
keyframe). Collectives are psums inside shard_map (NCCL over NVLink on
a multi-GPU host).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import icp as icp_ops
from ..ops import voxel_map as vm
from ..utils import lie
from .sharded_map import _SCALARS, _compact_owned, _local_view, \
    _owned_cap, _wrap_scalars, map_specs, owner_of_points, robust_icp_loop

__all__ = ["multichip_odometry_step", "batched_sharded_map_state"]


def batched_sharded_map_state(batch: int, c0_total: int, c1_total: int,
                              mesh: Mesh, data_axis: str = "data",
                              map_axis: str = "map") -> vm.VoxelMapState:
    """A batch of empty sharded maps: arrays (B, S*local, ...) sharded
    P(data, map); scalars (B, S)."""
    s = mesh.shape[map_axis]
    local = vm.empty_map(c0_total // s, c1_total // s)

    def rep(a):
        if a.ndim == 0:
            return jnp.broadcast_to(a, (batch, s)).copy()
        tiled = jnp.tile(a, (s,) + (1,) * (a.ndim - 1)).reshape(
            (s * a.shape[0],) + a.shape[1:])
        return jnp.broadcast_to(tiled, (batch,) + tiled.shape).copy()

    state = vm.VoxelMapState(*[rep(a) for a in tuple(local)])
    specs = map_specs(map_axis, batch_axis=data_axis)
    return vm.VoxelMapState(*[
        jax.device_put(a, NamedSharding(mesh, sp))
        for a, sp in zip(tuple(state), tuple(specs))])


def multichip_odometry_step(mesh: Mesh, cfg: icp_ops.ICPConfig,
                            *, update_max_distance: float = 120.0,
                            planarity_threshold: float = 0.1,
                            pko_consts=None,
                            data_axis: str = "data", map_axis: str = "map"):
    """Build the jitted multi-chip step.

    Returns step(state, pts, mask, T, is_keyframe) -> (T_new, state_new):
    state per batched_sharded_map_state, pts (B, N, 3) sharded P(data),
    T (B, 4, 4), is_keyframe (B,). The keyframe update is expressed as a
    masked update (a non-keyframe inserts nothing and evicts nothing) so
    it vmaps over the sequence batch."""
    n_shards = mesh.shape[map_axis]

    def per_shard(state, pts, mask, T, is_kf):
        cap = _owned_cap(pts.shape[-2], n_shards)

        def one_seq(st, p, m, T0, kf):
            st = _local_view(st)
            me = jax.lax.axis_index(map_axis)

            # full-parity distributed ICP: sigma/6 normalization, PKO,
            # robust weights, early exit (sharded_map.robust_icp_loop)
            T_new, _success, _n = robust_icp_loop(
                st, p, m, T0, cap, n_shards, map_axis, cfg, pko_consts)
            T_new = lie.se3_matrix(lie.so3_project(T_new[:3, :3]), T_new[:3, 3])

            # shard-local masked keyframe update on the O(scan/S) owned
            # subset: O(scan) comm, no table movement (VERDICT round-1
            # item 3)
            world_all = lie.transform_points(T_new, p)
            owner = owner_of_points(world_all, n_shards,
                                    voxel_size=cfg.voxel_size,
                                    hierarchy_factor=cfg.hierarchy_factor)
            w_own, ok, _ = _compact_owned(world_all, m & kf, owner, me, cap)
            st_out = vm.update_map(
                st, w_own, ok, T_new[:3, 3],
                jnp.where(kf, jnp.float32(update_max_distance),
                          jnp.float32(1e30)),
                voxel_size=cfg.voxel_size,
                planarity_threshold=planarity_threshold,
                hierarchy_factor=cfg.hierarchy_factor)
            return T_new, _wrap_scalars(st_out)

        return jax.vmap(one_seq)(state, pts, mask, T, is_kf)

    specs = map_specs(map_axis, batch_axis=data_axis)
    step = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(specs, P(data_axis), P(data_axis), P(data_axis),
                  P(data_axis)),
        out_specs=(P(data_axis), specs),
        check_vma=False)
    return jax.jit(step)
