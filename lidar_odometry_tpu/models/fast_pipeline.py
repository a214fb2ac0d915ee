"""Fused odometry fast path: N frames per device dispatch.

The reference processes scans one at a time on a CPU frame loop
(reference kitti_player.cpp:79-150 -> Estimator::process_frame). On an
accelerator, per-call dispatch and host round-trips would dominate at hundreds of
scans/s, so the whole per-frame pipeline — voxel filter, ICP (with PKO),
velocity model, keyframe decision, conditional map update — is expressed
as ONE pure function and rolled over a chunk of scans with `lax.scan`:
one XLA program per chunk, all SLAM state device-resident, poses and
keyframe flags returned per chunk.

Loop closure / PGO stay host-driven between chunks (they are asynchronous
to odometry in the reference too — the background thread of
Estimator.cpp:890); `Estimator` remains the full-featured orchestrator,
this module is the throughput engine used by bench.py and batch drivers.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import icp as icp_ops
from ..ops import pko as pko_ops
from ..ops import voxel_filter as vf
from ..ops import voxel_map as vm
from ..utils import lie

__all__ = ["OdomCarry", "init_carry", "make_chunk_runner",
           "init_batched_carry", "make_batched_chunk_runner",
           "init_blocked_carry", "make_blocked_runner"]


class OdomCarry(NamedTuple):
    map_state: vm.VoxelMapState
    T_prev: jax.Array          # (4,4) previous frame pose
    velocity: jax.Array        # (4,4) constant-velocity model
    last_kf_pose: jax.Array    # (4,4)
    initialized: jax.Array     # () bool
    kf_count: jax.Array        # () int32


def init_carry(c0: int, c1: int) -> OdomCarry:
    # distinct buffers per field: the chunk runner donates the carry, and
    # aliased buffers would be donated twice
    return OdomCarry(
        map_state=vm.empty_map(c0, c1),
        T_prev=jnp.eye(4, dtype=jnp.float32),
        velocity=jnp.eye(4, dtype=jnp.float32),
        last_kf_pose=jnp.eye(4, dtype=jnp.float32),
        initialized=jnp.bool_(False), kf_count=jnp.int32(0))


def make_chunk_runner(icp_cfg: icp_ops.ICPConfig, pko_consts: pko_ops.PKOConstants,
                      **kw):
    """Build chunk(carry, scans (F, N, 3)) -> (carry, (poses (F,4,4),
    is_kf (F,), n_corr (F,))) — plus (feats (F,cap,3), masks (F,cap))
    when built with return_features=True. Scans are raw padded clouds;
    pad slots must be non-finite (NaN) so the voxel filter drops them
    (reference semantics: Estimator.cpp:561-589 preprocess + :116-233)."""
    frame_step = _make_frame_step(icp_cfg, pko_consts, masked_update=False, **kw)

    # The carry (which contains the full map state) is donated: callers
    # must treat the passed-in carry as consumed (all in-tree callers
    # reassign it). Donation lets XLA alias the state buffers in place
    # through the keyframe conditional instead of copying them per frame.
    @partial(jax.jit, donate_argnums=(0,))
    def chunk(carry: OdomCarry, scans):
        return jax.lax.scan(frame_step, carry, scans)

    return chunk


def _make_parts(icp_cfg: icp_ops.ICPConfig, pko_consts: pko_ops.PKOConstants,
                *, scan_voxel_size: float, point_stride: int,
                scan_capacity: int, keyframe_distance: float,
                keyframe_rotation: float, max_distance: float,
                planarity_threshold: float, compute_surfels: bool = True):
    """Split the per-frame pipeline into `pre` (filter + ICP + velocity +
    keyframe decision — map read-only) and the two map-update styles, so
    the single-stream and batched runners compose them differently."""

    # compact single-u32 filter keys when their ±512-voxel envelope covers
    # any plausible LiDAR return (200 m; KITTI HDL-64E ~120 m) — the
    # 2-operand sort is measurably cheaper than the generic 3-operand one
    compact = vf.compact_keys_ok(scan_voxel_size, 200.0)

    def pre(carry: OdomCarry, raw_scan, home=None):
        feat, mask, _ = vf.voxel_filter(
            raw_scan, jnp.int32(raw_scan.shape[0]),
            voxel_size=scan_voxel_size, stride=point_stride,
            out_capacity=scan_capacity, compact_keys=compact)

        guess = carry.T_prev @ carry.velocity
        T_icp, success, n_corr = icp_ops.icp_optimize(
            carry.map_state, feat, mask, guess, pko_consts, icp_cfg)
        # `home` (blocked multi-sequence runner) is the lane's world
        # origin — lanes live at disjoint coordinate offsets in the
        # shared map
        eye = jnp.eye(4, dtype=jnp.float32) if home is None else home
        # Re-orthonormalize the rotation once per frame: the velocity-model
        # recursion T_prev @ inv(T_prev2) @ T_prev SQUARES any shear in R
        # (se3_inv assumes orthogonality), which otherwise compounds
        # exponentially. The reference gets this implicitly by projecting
        # to SO(3) on every SE3 construction (MathUtils.cpp:86-99).
        T_icp = lie.se3_matrix(lie.so3_project(T_icp[:3, :3]), T_icp[:3, 3])
        T = jnp.where(carry.initialized, T_icp, eye)

        velocity = jnp.where(carry.initialized,
                             lie.se3_inv(carry.T_prev) @ T,
                             jnp.eye(4, dtype=jnp.float32))

        # Keyframe decision (reference should_create_keyframe,
        # Estimator.cpp:349-368)
        diff = T[:3, 3] - carry.last_kf_pose[:3, 3]
        dist = jnp.linalg.norm(diff)
        R_rel = carry.last_kf_pose[:3, :3].T @ T[:3, :3]
        cos_t = jnp.clip((jnp.trace(R_rel) - 1.0) * 0.5, -1.0, 1.0)
        angle = jnp.arccos(cos_t)
        is_kf = (~carry.initialized) | (dist > keyframe_distance) | (angle > keyframe_rotation)
        return T, velocity, is_kf, n_corr, feat, mask

    def masked_update(map_state, T, feat, mask, is_kf):
        # vmap/select-safe: run the update unconditionally but make a
        # non-keyframe a no-op (no inserts; eviction disabled by an
        # infinite radius). Same semantics as the cond.
        world = lie.transform_points(T, feat)
        return vm.update_map(
            map_state, world, mask & is_kf, T[:3, 3],
            jnp.where(is_kf, jnp.float32(max_distance), jnp.float32(1e30)),
            voxel_size=icp_cfg.voxel_size,
            planarity_threshold=planarity_threshold,
            hierarchy_factor=icp_cfg.hierarchy_factor,
            compute_surfels=compute_surfels)

    def cond_update(map_state, T, feat, mask, is_kf, kf_count):
        def do_update(ms):
            world = lie.transform_points(T, feat)
            # the full-table radius-eviction scan runs every 4th
            # keyframe only (eviction is a deferred process bounded by
            # caps anyway; the stride just delays individual evictions
            # <=3 keyframes) — the scan is a fixed O(c1*27) pass that
            # was a measured slice of every update
            return vm.update_map(
                ms, world, mask, T[:3, 3], max_distance,
                voxel_size=icp_cfg.voxel_size,
                planarity_threshold=planarity_threshold,
                hierarchy_factor=icp_cfg.hierarchy_factor,
                compute_surfels=compute_surfels,
                evict_enabled=(kf_count % 4 == 0))

        return jax.lax.cond(is_kf, do_update, lambda ms: ms, map_state)

    return pre, masked_update, cond_update


def _make_frame_step(icp_cfg: icp_ops.ICPConfig, pko_consts: pko_ops.PKOConstants,
                     *, masked_update: bool = False,
                     return_features: bool = False, **kw):
    pre, mupd, cupd = _make_parts(icp_cfg, pko_consts, **kw)

    def frame_step(carry: OdomCarry, raw_scan):
        T, velocity, is_kf, n_corr, feat, mask = pre(carry, raw_scan)
        if masked_update:
            map_state = mupd(carry.map_state, T, feat, mask, is_kf)
        else:
            map_state = cupd(carry.map_state, T, feat, mask, is_kf,
                             carry.kf_count)
        new_carry = OdomCarry(
            map_state=map_state, T_prev=T, velocity=velocity,
            last_kf_pose=jnp.where(is_kf, T, carry.last_kf_pose),
            initialized=jnp.bool_(True),
            kf_count=carry.kf_count + is_kf.astype(jnp.int32))
        out = (T, is_kf, n_corr)
        if return_features:
            # feature clouds ride out with the chunk so keyframe
            # bookkeeping (loop-closure DB, KeyframeRecord) needs no
            # per-keyframe re-preprocess dispatch (one device->host
            # transfer per chunk instead of one per keyframe)
            out = out + (feat, mask)
        return new_carry, out

    return frame_step


def init_blocked_carry(batch: int, c0: int, c1: int,
                       lane_spacing_m: float = 1024.0) -> OdomCarry:
    """Carry for the blocked shared-map runner: ONE map (size it B-x the
    single-sequence capacity), per-lane pose state starting at each
    lane's coordinate offset."""
    homes = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    homes[:, 0, 3] = np.arange(batch, dtype=np.float32) * lane_spacing_m
    return OdomCarry(
        map_state=vm.empty_map(c0, c1),
        T_prev=jnp.asarray(homes),
        velocity=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                  (batch, 4, 4)).copy(),
        last_kf_pose=jnp.asarray(homes.copy()),
        initialized=jnp.zeros((batch,), bool),
        kf_count=jnp.zeros((batch,), jnp.int32))


def make_blocked_runner(icp_cfg: icp_ops.ICPConfig,
                        pko_consts: pko_ops.PKOConstants, *,
                        batch: int, block: int = 4,
                        lane_spacing_m: float = 1024.0, **kw):
    """Multi-sequence throughput v3: B independent sequences share ONE
    voxel map at disjoint coordinate offsets (lane b's world shifts by
    b*lane_spacing_m in x — far beyond the eviction radius, so lanes
    never interact; eviction tests min distance over the B lane sensors,
    ops/voxel_map.update_map multi-sensor support).

    This kills both costs that made the round-2 per-lane-map design
    UNPROFITABLE (363 vs ~500 scans/s single-stream):
      * per-lane map copies — the lane scan's xs/ys could not alias B
        map states through the per-lane conds, so every lane paid a full
        map copy per frame; one shared map is ONE carry buffer that
        donates/aliases exactly like single-stream;
      * conditional identity branches — there is NO keyframe cond at
        all: frames process in blocks of `block`, and each block ends
        with ONE unconditional masked update inserting every lane's
        keyframe features (masked per lane-frame). Fixed per-op costs
        (sorts, compactions, scatter setup) amortize over block*B
        keyframe slots. Lookups lag keyframes by <= block-1 frames (the
        same bounded-staleness trade as the sharded update_batch;
        accuracy bound proven in tests/test_fast_pipeline.py).

    chunk(carry, scans (B, F, N, 3)) -> (carry, (poses (B, F, 4, 4),
    is_kf (B, F), n_corr (B, F))), poses reported with lane offsets
    removed. F must be a multiple of `block`.
    """
    max_distance = kw["max_distance"]
    planarity_threshold = kw["planarity_threshold"]
    pre, _, _ = _make_parts(icp_cfg, pko_consts, **kw)
    offs = np.zeros((batch, 3), np.float32)
    offs[:, 0] = np.arange(batch) * lane_spacing_m
    offs_j = jnp.asarray(offs)
    homes = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    homes[:, :3, 3] = offs
    homes_j = jnp.asarray(homes)

    lane_axes = OdomCarry(map_state=None, T_prev=0, velocity=0,
                          last_kf_pose=0, initialized=0, kf_count=0)

    def block_body(carry: OdomCarry, xs):
        # scans_blk (block, B, N, 3); frames stay sequential, lanes vmap
        scans_blk, blk_i = xs
        outs = []
        ins_pts, ins_msk = [], []
        for j in range(block):
            T, vel, is_kf, n_corr, feat, mask = jax.vmap(
                pre, in_axes=(lane_axes, 0, 0))(carry, scans_blk[j],
                                                homes_j)
            carry = OdomCarry(
                map_state=carry.map_state, T_prev=T, velocity=vel,
                last_kf_pose=jnp.where(is_kf[:, None, None], T,
                                       carry.last_kf_pose),
                initialized=jnp.ones_like(carry.initialized),
                kf_count=carry.kf_count + is_kf.astype(jnp.int32))
            # keyframe features in (offset) world frame, masked per lane
            world = jax.vmap(lie.transform_points)(T, feat)
            ins_pts.append(world)
            ins_msk.append(mask & is_kf[:, None])
            T_out = T.at[:, :3, 3].add(-offs_j)      # report true poses
            outs.append((T_out, is_kf, n_corr))

        # ONE unconditional masked update per block: no cond, no copy
        pts_all = jnp.concatenate(ins_pts).reshape(-1, 3)
        msk_all = jnp.concatenate(ins_msk).reshape(-1)
        sensors = carry.T_prev[:, :3, 3]             # (B, 3) lane sensors
        # Compact LIVE inserts before the update: the raw concat is
        # block*B*scan_capacity slots but only keyframe lane-frames are
        # unmasked (~1 keyframe per lane per block at steady state), so
        # >60% of every per-point pass in update_map processed dead
        # slots. Cap = 1.5 keyframes per lane per block; overflow (only
        # if >6 of 16 lane-frames keyframe at once) drops points
        # VISIBLY into n_dropped.
        p_raw = pts_all.shape[0]
        ins_cap = (batch * ins_pts[0].shape[-2] * 3) // 2
        if ins_cap < p_raw:
            keep_idx, n_live = vm._compact(msk_all, ins_cap)
            ok = keep_idx >= 0
            ki = jnp.clip(keep_idx, 0, p_raw - 1)
            pts_all = jnp.where(ok[:, None], pts_all[ki], 0.0)
            msk_all = ok
            overflow = jnp.maximum(n_live - ins_cap, 0)
        else:
            overflow = jnp.int32(0)
        # the full-table radius-eviction scan runs on every 4th block
        # only — the blocked runner updates ~5x more often than the
        # single-stream keyframe cadence, and eviction is already a
        # deferred process (caps), so striding it merely delays
        # individual evictions by <=3 blocks
        map_state = vm.update_map(
            carry.map_state, pts_all, msk_all, sensors,
            jnp.float32(max_distance),
            voxel_size=icp_cfg.voxel_size,
            planarity_threshold=planarity_threshold,
            hierarchy_factor=icp_cfg.hierarchy_factor,
            evict_enabled=(blk_i % 4 == 0))
        map_state = map_state._replace(
            n_dropped=map_state.n_dropped + overflow)
        carry = carry._replace(map_state=map_state)
        T_s = jnp.stack([o[0] for o in outs])        # (block, B, 4, 4)
        kf_s = jnp.stack([o[1] for o in outs])
        nc_s = jnp.stack([o[2] for o in outs])
        return carry, (T_s, kf_s, nc_s)

    @partial(jax.jit, donate_argnums=(0,))
    def chunk(carry: OdomCarry, scans):
        b, f, n, _ = scans.shape
        blk = jnp.swapaxes(scans, 0, 1).reshape(f // block, block, b, n, 3)
        blk_ids = jnp.arange(f // block, dtype=jnp.int32)
        carry, (T, kf, nc) = jax.lax.scan(block_body, carry,
                                          (blk, blk_ids))
        # (F/block, block, B, ...) -> (B, F, ...)
        def fix(a):
            a = a.reshape((f,) + a.shape[2:])
            return jnp.moveaxis(a, 1, 0)
        return carry, (fix(T), fix(kf), fix(nc))

    return chunk


def init_batched_carry(batch: int, c0: int, c1: int) -> OdomCarry:
    one = init_carry(c0, c1)
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape).copy(), one)


def make_batched_chunk_runner(icp_cfg: icp_ops.ICPConfig,
                              pko_consts: pko_ops.PKOConstants, **kw):
    """Multi-sequence throughput mode: the per-frame pipeline batched over
    B independent sequences (the data-parallel axis of SURVEY.md §2.4, on
    one chip). The ICP/filter stage is vmapped per frame; the map update
    is vmapped under ONE batch-level `lax.cond` on `any(is_kf)` — frames
    where no sequence keyframes skip the update entirely (a round-1
    version vmapped the whole step, which turned the per-sequence cond
    into a select and paid the full update every frame), and per-sequence
    no-ops stay masked. The carry is donated like the single-stream
    runner, so the B map states update in place.

    chunk(carry_B, scans (B, F, N, 3)) -> (carry_B, (poses (B, F, 4, 4),
    is_kf (B, F), n_corr (B, F))).
    """
    pre, _, cupd = _make_parts(icp_cfg, pko_consts, **kw)

    def bstep(carry: OdomCarry, raw_scans):
        T, velocity, is_kf, n_corr, feat, mask = jax.vmap(pre)(carry, raw_scans)

        # Per-lane REAL conditionals via a lane scan, not vmap: update_map
        # is internally cond-tiered (steady vs bulk caps, evict gating),
        # and under vmap every cond becomes a select that executes BOTH
        # branches for all lanes every frame — measured 10x slower than
        # single-stream. A scan over the B lanes keeps each lane's
        # keyframe cond (and the conds inside update_map) as true
        # branches, so non-keyframe lanes cost nothing.
        def lane(_, xs):
            ms, T_l, feat_l, mask_l, kf_l, kc_l = xs
            return _, cupd(ms, T_l, feat_l, mask_l, kf_l, kc_l)

        _, map_state = jax.lax.scan(
            lane, 0, (carry.map_state, T, feat, mask, is_kf,
                      carry.kf_count))
        new_carry = OdomCarry(
            map_state=map_state, T_prev=T, velocity=velocity,
            last_kf_pose=jnp.where(is_kf[:, None, None], T,
                                   carry.last_kf_pose),
            initialized=jnp.ones_like(carry.initialized),
            kf_count=carry.kf_count + is_kf.astype(jnp.int32))
        return new_carry, (T, is_kf, n_corr)

    @partial(jax.jit, donate_argnums=(0,))
    def chunk(carry: OdomCarry, scans):
        carry, (T, is_kf, n_corr) = jax.lax.scan(
            bstep, carry, jnp.swapaxes(scans, 0, 1))
        return carry, (jnp.swapaxes(T, 0, 1), jnp.swapaxes(is_kf, 0, 1),
                       jnp.swapaxes(n_corr, 0, 1))

    return chunk
