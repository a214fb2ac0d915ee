"""Spatially-sharded voxel surfel map over a device mesh.

Ownership is by PARENT-CELL hash: shard s owns every L1 cell whose key
hashes to s (mod n_shards), and every L0 voxel whose parent hashes to s —
children are therefore CO-LOCATED with their parent, so each shard is a
complete, independent single-chip map (ops/voxel_map.py) holding its own
bucket index, slot stores and free stacks. This is the device-mesh
analog of distributing the reference's hash tables (reference
src/database/VoxelMap.h:309,324) across devices (SURVEY.md §2.4).

Communication costs (the round-2 redesign; round 1 all-gathered the whole
map per keyframe):
  * lookup: queries are replicated; a shard that does not own a key simply
    misses its local index, so exactly one shard answers and a psum
    combines — O(queries) bytes, no table movement.
  * UPDATE: each shard runs the full single-chip update on the replicated
    scan masked to its owned points — ZERO table communication, O(scan)
    broadcast only.
  * ICP: per-shard partial 6x6 normal equations + psum — O(36) floats.
  * rehash (loop-closure correction, rare): voxels change owner, so live
    (centroid, count) records are all_gathered and each shard bulk-builds
    the subset it now owns — O(map) once per accepted loop closure
    (reference rebuilds the whole table single-threaded,
    VoxelMap.cpp:264-302).
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import icp as icp_ops
from ..ops import voxel_map as vm
from ..utils import keys as K
from ..utils import lie

__all__ = ["sharded_empty_map", "owner_of_points", "sharded_update_map",
           "sharded_lookup_surfels", "sharded_icp_step",
           "sharded_icp_optimize", "sharded_transform_and_rehash",
           "map_specs", "gather_state"]

_SCALARS = ("l1_free_top", "n_l0", "n_l1", "n_dropped")


def map_specs(mesh_axis: str = "map", batch_axis: str = None) -> vm.VoxelMapState:
    """PartitionSpec per field: every array (including the bucket indices
    and the per-shard scalars, stored as (S,) vectors) shards over
    `mesh_axis`; an optional leading batch axis shards over `batch_axis`."""
    lead = (batch_axis,) if batch_axis else ()
    return vm.VoxelMapState(**{
        name: P(*lead, mesh_axis) for name in vm.VoxelMapState._fields})


def sharded_empty_map(c0_total: int, c1_total: int, mesh: Mesh,
                      mesh_axis: str = "map") -> vm.VoxelMapState:
    """Empty sharded map with TOTAL capacities split across shards. Arrays
    have global shapes (n_shards * local, ...) sharded on axis 0; scalar
    fields become (n_shards,) vectors (one per shard)."""
    s = mesh.shape[mesh_axis]
    local = vm.empty_map(c0_total // s, c1_total // s)

    def rep(a):
        if a.ndim == 0:
            return jnp.broadcast_to(a, (s,)).copy()
        return jnp.tile(a, (s,) + (1,) * (a.ndim - 1)).reshape(
            (s * a.shape[0],) + a.shape[1:])

    state = vm.VoxelMapState(*[rep(a) for a in tuple(local)])
    specs = map_specs(mesh_axis)
    return vm.VoxelMapState(*[
        jax.device_put(a, NamedSharding(mesh, sp))
        for a, sp in zip(tuple(state), tuple(specs))])


def _local_view(st: vm.VoxelMapState) -> vm.VoxelMapState:
    """Inside shard_map each field arrives with its local shape; scalar
    fields arrive as (1,) slices — unwrap them."""
    return vm.VoxelMapState(*[
        (a[0] if name in _SCALARS else a)
        for name, a in zip(vm.VoxelMapState._fields, tuple(st))])


def _wrap_scalars(st: vm.VoxelMapState) -> vm.VoxelMapState:
    return vm.VoxelMapState(*[
        (a[None] if name in _SCALARS else a)
        for name, a in zip(vm.VoxelMapState._fields, tuple(st))])


def owner_of_points(pts: jax.Array, n_shards: int, *, voxel_size,
                    hierarchy_factor: int = 3) -> jax.Array:
    """Owning shard of each point = hash of its PARENT cell key mod S
    (an independent hash from the in-shard bucket hash so shard and
    bucket choices stay uncorrelated)."""
    inv = 1.0 / (voxel_size * hierarchy_factor)
    coords = K.voxel_coords(pts, inv)
    hi, lo = K.pack_key(coords)
    h = (hi * jnp.uint32(0x85EBCA77)) ^ (lo * jnp.uint32(0xC2B2AE3D))
    h = (h ^ (h >> jnp.uint32(16))) * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> jnp.uint32(15))
    return (h % jnp.uint32(n_shards)).astype(jnp.int32)


def _owned_cap(n: int, n_shards: int) -> int:
    """Static per-shard point capacity: N/S with scale-aware headroom for
    the per-parent-cell hash imbalance (points cluster into 1.5 m cells,
    so the worst shard's share fluctuates far more for sparse scans than
    dense ones). Margin = 1 + 30*S/sqrt(N), clamped to [1.1, 2.2] —
    >=1.5x the worst observed overload on both bench workloads
    (131k-pt KITTI-like scans: 1.07/1.20/1.36 at S=2/4/8; 16k-pt ring
    scans: 1.38/1.62/2.13), where the old flat 1.375 was both wasteful
    at the dense S=2 point (the update is ~linear in cap, so a 37%
    oversized buffer was most of that configuration's strong-scaling
    loss) and insufficient for sparse S>=4. Multiple of 256; overflow
    drops are counted by the map (n_dropped)."""
    if n_shards <= 1:
        return n
    margin = min(max(1.0 + 30.0 * n_shards / np.sqrt(n), 1.1), 2.2)
    cap = int(np.ceil(n / n_shards * margin / 256.0)) * 256
    return min(cap, n)


def _compact_owned(pts, mask, owner, me, cap: int):
    """Gather this shard's owned points into a (cap, 3) buffer so all
    downstream per-shard work is O(N/S), not O(N)."""
    mine = mask & (owner == me)
    n = pts.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(mine, idx, jnp.int32(n))
    order = jax.lax.sort(key)[:cap]
    ok = order < n
    sel = jnp.clip(order, 0, n - 1)
    return pts[sel], ok, sel


def sharded_update_map(state: vm.VoxelMapState, pts: jax.Array,
                       mask: jax.Array, sensor_pos: jax.Array,
                       max_distance, mesh: Mesh, *, voxel_size,
                       planarity_threshold, hierarchy_factor: int = 3,
                       compute_surfels: bool = True,
                       mesh_axis: str = "map") -> vm.VoxelMapState:
    """Distributed UpdateVoxelMap: every shard compacts its owned subset
    of the (replicated) scan to an O(scan/S) buffer and runs the
    single-chip update on it. No collectives at all — per-keyframe
    communication is the O(scan) broadcast of the points, and per-shard
    COMPUTE is O(scan/S)."""
    n_shards = mesh.shape[mesh_axis]
    cap = _owned_cap(pts.shape[0], n_shards)

    def kernel(st, p, m, spos):
        me = jax.lax.axis_index(mesh_axis)
        owner = owner_of_points(p, n_shards, voxel_size=voxel_size,
                                hierarchy_factor=hierarchy_factor)
        p_own, ok, _ = _compact_owned(p, m, owner, me, cap)
        out = vm.update_map(_local_view(st), p_own, ok, spos, max_distance,
                            voxel_size=voxel_size,
                            planarity_threshold=planarity_threshold,
                            hierarchy_factor=hierarchy_factor,
                            compute_surfels=compute_surfels)
        return _wrap_scalars(out)

    specs = map_specs(mesh_axis)
    return jax.shard_map(
        kernel, mesh=mesh, in_specs=(specs, P(), P(), P()),
        out_specs=specs, check_vma=False)(state, pts, mask, sensor_pos)


def sharded_lookup_surfels(state: vm.VoxelMapState, pts: jax.Array,
                           mesh: Mesh, *, voxel_size,
                           hierarchy_factor: int = 3,
                           mesh_axis: str = "map"):
    """Distributed GetSurfelAtPoint: replicated queries, owner answers
    (non-owners miss their local index), psum combine."""

    def kernel(st, q):
        n, c, v = vm.lookup_surfels(_local_view(st), q,
                                    voxel_size=voxel_size,
                                    hierarchy_factor=hierarchy_factor)
        vf = v.astype(jnp.float32)[:, None]
        n = jax.lax.psum(n * vf, mesh_axis)
        c = jax.lax.psum(c * vf, mesh_axis)
        v = jax.lax.psum(v.astype(jnp.int32), mesh_axis) > 0
        return n, c, v

    return jax.shard_map(
        kernel, mesh=mesh, in_specs=(map_specs(mesh_axis), P()),
        out_specs=(P(), P(), P()), check_vma=False)(state, pts)


def sharded_icp_step(state: vm.VoxelMapState, pts: jax.Array, mask: jax.Array,
                     T: jax.Array, mesh: Mesh, cfg: icp_ops.ICPConfig,
                     mesh_axis: str = "map"):
    """One distributed GN step: per-shard correspondences + partial (H, g),
    psum over the map axis, replicated 6x6 solve + retraction — the
    distributed version of the reference's GN accumulation
    (IterativeClosestPointOptimizer.cpp:359-410).
    Returns (T_new, n_correspondences)."""

    n_shards = mesh.shape[mesh_axis]
    cap = _owned_cap(pts.shape[0], n_shards)

    def kernel(st, p, m, T_in):
        # a query can only hit its parent cell's OWNER shard, so each
        # shard compacts its owned queries and works on O(scan/S) points;
        # the psum'd partial normal equations are exact
        R, t = lie.se3_rt(T_in)
        p_world_all = p @ R.T + t[None, :]
        me = jax.lax.axis_index(mesh_axis)
        owner = owner_of_points(p_world_all, n_shards,
                                voxel_size=cfg.voxel_size,
                                hierarchy_factor=cfg.hierarchy_factor)
        p_own, ok, _ = _compact_owned(p, m, owner, me, cap)
        p_world = p_own @ R.T + t[None, :]
        normal, centroid, hit = vm.lookup_surfels(
            _local_view(st), p_world, voxel_size=cfg.voxel_size,
            hierarchy_factor=cfg.hierarchy_factor)
        r = jnp.sum(normal * (p_world - centroid), axis=-1)
        valid = hit & ok & (jnp.abs(r) <= cfg.max_correspondence_distance)
        w = valid.astype(jnp.float32)
        a = normal @ R
        J = jnp.concatenate([a, jnp.cross(p_own, a)], axis=-1)
        H = jax.lax.psum(J.T @ (J * w[:, None]), mesh_axis)
        g = jax.lax.psum(J.T @ (w * r), mesh_axis)
        n = jax.lax.psum(jnp.sum(w), mesh_axis)
        H = H + jnp.eye(6) * 1e-8
        delta = jnp.linalg.solve(H, -g)
        T_new = T_in @ lie.se3_from_exp_rt(delta[:3], delta[3:])
        return T_new, n

    return jax.shard_map(
        kernel, mesh=mesh,
        in_specs=(map_specs(mesh_axis), P(), P(), P()),
        out_specs=(P(), P()), check_vma=False)(state, pts, mask, T)


def robust_icp_loop(local_state: vm.VoxelMapState, p, m, T0, cap: int,
                    n_shards: int, mesh_axis: str, cfg: icp_ops.ICPConfig,
                    pko_consts=None):
    """Per-shard body of the FULL distributed ICP with the single-chip
    engine's semantics (ops/icp.icp_optimize): iteration-0 residual
    normalization sigma/6 via psum'd raw moments, PKO adaptive delta,
    huber/cauchy robust weights, early-exit while_loop, and
    fall-back-to-guess on failure (reference
    IterativeClosestPointOptimizer.cpp:255-463). Call inside a shard_map
    (optionally under vmap over a sequence batch).

    Collective structure (the strong-scaling redesign; the round-2
    version paid ~4 sequential collective rounds per iteration):
      * ONE moments psum before the loop (count + raw sum/sum-sq of
        |r| at the guess -> sigma/6 scale, iteration 0 of the single-
        chip engine hoisted out of the while_loop);
      * ONE fused psum per GN iteration. PKO's kernel-scale choice only
        depends on (a) a stratified sample of the global normalized
        residuals and (b) which alpha wins the JS argmin — so each
        shard contributes a stratified sample of its OWN residuals
        into its slice of a fixed sample buffer, and the 6x6 normal
        equations are accumulated PER CANDIDATE ALPHA as one
        (A, n)@(n, 42) matmul (work that scales with n/S). The
        [per-alpha systems | sample slots | count] buffer psums as a
        single ~17 KB collective; the GMM fit + JS argmin then runs
        replicated on identical psum'd samples and selects the
        already-reduced system — no residual all_gather, no second
        sequential round. The sample is drawn per-shard (quota
        ceil(m/S) each) instead of over a gathered array: same
        stratified-subsample semantics on the same multiset, different
        (deterministic, fold_in(42, shard)) index sequence — the
        converged-pose equivalence bound is tested in
        tests/test_parallel.py.

    The owned subset is compacted ONCE at the initial guess: a point
    whose parent cell migrates to another shard mid-optimization simply
    misses the local index that iteration (correspondence deferred to
    the next call — ICP steps are well under the 3-voxel parent size),
    which removes the O(scan) ownership recompaction the round-2
    version paid per iteration.

    Returns (T_opt, success, n_correspondences)."""
    from ..ops import pko as pko_ops
    from ..ops.icp import _robust_weights

    me = jax.lax.axis_index(mesh_axis)
    # PKO only picks the robust-kernel scale — with use_robust_loss=False
    # the single-chip engine uses UNIT weights regardless of the
    # m-estimator flag (icp.py _gn_step), so the per-alpha machinery must
    # be bypassed too or the backends diverge (round-3 advisor finding).
    use_pko = (cfg.use_robust_loss and cfg.use_adaptive_m_estimator
               and pko_consts is not None)

    R0, t0 = lie.se3_rt(T0)
    owner = owner_of_points(p @ R0.T + t0[None, :], n_shards,
                            voxel_size=cfg.voxel_size,
                            hierarchy_factor=cfg.hierarchy_factor)
    p_own, ok_own, _ = _compact_owned(p, m, owner, me, cap)

    if use_pko:
        n_alpha = int(pko_consts.alphas.shape[0])
        quota = -(-int(pko_consts.gmm_sample_size) // n_shards)
        skey = jax.random.fold_in(jax.random.PRNGKey(42), me)

    def residuals_at(T):
        R, t = lie.se3_rt(T)
        pw = p_own @ R.T + t[None, :]
        normal, centroid, hit = vm.lookup_surfels(
            local_state, pw, voxel_size=cfg.voxel_size,
            hierarchy_factor=cfg.hierarchy_factor)
        r = jnp.sum(normal * (pw - centroid), axis=-1)
        valid = hit & ok_own & (jnp.abs(r) <= cfg.max_correspondence_distance)
        return R, normal, r, valid

    def gn_round(T, scale, res):
        """One GN iteration from precomputed residuals: ONE fused psum.
        Returns (T_new, converged, insufficient, count)."""
        R, normal, r, valid = res
        w = valid.astype(jnp.float32)
        norm_resid = jnp.abs(r) / jnp.maximum(scale, 1e-6)
        a = normal @ R
        J = jnp.concatenate([a, jnp.cross(p_own, a)], axis=-1)
        # per-point GN contributions: vec(J J^T) (36) | J*r (6)
        Z = jnp.concatenate(
            [(J[:, :, None] * J[:, None, :]).reshape(-1, 36),
             J * r[:, None]], axis=1)
        cnt = jnp.sum(w)

        if use_pko:
            W = _robust_weights(norm_resid[None, :],
                                pko_consts.alphas[:, None],
                                cfg.loss_type) * w[None, :]
            partials = W @ Z                                  # (A, 42)
            samp, sok = pko_ops.stratified_sample(norm_resid, valid,
                                                  quota, skey)
            sokf = sok.astype(jnp.float32)
            zeros_s = jnp.zeros((n_shards * quota,), jnp.float32)
            sbuf = jax.lax.dynamic_update_slice(zeros_s, samp * sokf,
                                                (me * quota,))
            obuf = jax.lax.dynamic_update_slice(zeros_s, sokf,
                                                (me * quota,))
            buf = jnp.concatenate([partials.reshape(-1), sbuf, obuf,
                                   cnt[None]])
            buf = jax.lax.psum(buf, mesh_axis)
            n42 = n_alpha * 42
            partials = buf[:n42].reshape(n_alpha, 42)
            s_all = buf[n42: n42 + n_shards * quota]
            o_all = buf[n42 + n_shards * quota: n42 + 2 * n_shards * quota]
            count = buf[-1]
            # slots from shards with too few valid residuals fall back to
            # the mean of the contributed ones (never poison the GMM)
            meanv = jnp.sum(s_all) / jnp.maximum(jnp.sum(o_all), 1.0)
            s_fin = jnp.where(o_all > 0.5, s_all, meanv)
            best = pko_ops.pko_alpha_index_from_samples(s_fin, pko_consts)
            HG = partials[best]
        else:
            delta = jnp.asarray(cfg.robust_loss_delta, jnp.float32)
            if cfg.use_robust_loss:
                w_rob = _robust_weights(norm_resid, delta, cfg.loss_type) * w
            else:
                w_rob = w
            buf = jax.lax.psum(jnp.concatenate([w_rob @ Z, cnt[None]]),
                               mesh_axis)
            HG, count = buf[:42], buf[42]

        H = HG[:36].reshape(6, 6) + jnp.eye(6) * 1e-8
        g = HG[36:42]
        insufficient = count < cfg.min_correspondence_points
        delta_x = jnp.linalg.solve(H, -g)
        fin = jnp.all(jnp.isfinite(delta_x))
        dt = jnp.where(fin, delta_x[:3], 0.0)
        dw = jnp.where(fin, delta_x[3:], 0.0)
        T_new = T @ lie.se3_from_exp_rt(dt, dw)
        converged = ((jnp.linalg.norm(dt) < cfg.translation_tolerance)
                     & (jnp.linalg.norm(dw) < cfg.rotation_tolerance))
        return T_new, converged, insufficient, count

    # ---- iteration 0, unrolled: moments psum (sigma/6 scale at the
    # guess, icp.py _norm_scale_from via raw moments) + first GN round ----
    res0 = residuals_at(T0)
    r_abs0 = jnp.abs(res0[2])
    w0 = res0[3].astype(jnp.float32)
    mom = jax.lax.psum(jnp.stack([jnp.sum(w0), jnp.sum(r_abs0 * w0),
                                  jnp.sum(r_abs0 * r_abs0 * w0)]),
                       mesh_axis)
    n0 = jnp.maximum(mom[0], 1.0)
    mean0 = mom[1] / n0
    var0 = jnp.maximum(mom[2] / n0 - mean0 * mean0, 0.0)
    scale = jnp.sqrt(var0) / 6.0

    T1, conv0, insuff0, cnt0 = gn_round(T0, scale, res0)
    step0 = ~insuff0
    T1 = jnp.where(step0, T1, T0)
    done0 = insuff0 | (step0 & conv0)
    failed0 = insuff0
    ncorr0 = jnp.where(step0, jnp.round(cnt0).astype(jnp.int32),
                       jnp.int32(0))

    def body(carry):
        i, T, done, n_corr, failed = carry
        res = residuals_at(T)
        T_new, conv, insuff, cnt = gn_round(T, scale, res)
        step_active = ~done & ~insuff
        T_out = jnp.where(step_active, T_new, T)
        done_out = done | insuff | (step_active & conv)
        failed_out = failed | (~done & insuff)
        n_corr_out = jnp.where(step_active,
                               jnp.round(cnt).astype(jnp.int32), n_corr)
        return (i + 1, T_out, done_out, n_corr_out, failed_out)

    def cond(carry):
        i, _T, done, _n, _f = carry
        return (i < cfg.max_iterations) & ~done

    init = (jnp.int32(1), T1, done0, ncorr0, failed0)
    _, T, done, n_corr, failed = jax.lax.while_loop(cond, body, init)
    success = ~failed
    return jnp.where(success, T, T0), success, n_corr


def sharded_icp_optimize(state: vm.VoxelMapState, pts: jax.Array,
                         mask: jax.Array, T_init: jax.Array, mesh: Mesh,
                         cfg: icp_ops.ICPConfig, pko_consts=None,
                         mesh_axis: str = "map"):
    """Full distributed scan-to-map ICP with single-chip engine parity
    (sigma/6 + PKO + robust weights + early exit) — the multichip
    equivalent of ops/icp.icp_optimize. Returns (T_opt, success, n)."""
    n_shards = mesh.shape[mesh_axis]
    cap = _owned_cap(pts.shape[0], n_shards)

    def kernel(st, p, m, T_in):
        return robust_icp_loop(_local_view(st), p, m, T_in, cap, n_shards,
                               mesh_axis, cfg, pko_consts)

    return jax.shard_map(
        kernel, mesh=mesh,
        in_specs=(map_specs(mesh_axis), P(), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)(state, pts, mask, T_init)


def sharded_transform_and_rehash(state: vm.VoxelMapState, T: jax.Array,
                                 mesh: Mesh, *, voxel_size,
                                 planarity_threshold,
                                 hierarchy_factor: int = 3,
                                 mesh_axis: str = "map") -> vm.VoxelMapState:
    """Distributed ApplyTransformAndRehash: transformed voxels change
    owner, so every shard all_gathers the live (centroid, count) records
    and bulk-builds the subset it now owns. O(map) comm, but only on
    accepted loop closures."""
    n_shards = mesh.shape[mesh_axis]

    def kernel(st):
        loc = _local_view(st)
        cnt = loc.l0_data[:, 0]
        centroid = loc.l0_data[:, 1:4] / jnp.maximum(cnt, 1.0)[:, None]
        R, t = T[:3, :3], T[:3, 3]
        moved = centroid @ R.T + t[None, :]
        all_moved = jax.lax.all_gather(moved, mesh_axis, tiled=True)
        all_cnt = jax.lax.all_gather(cnt, mesh_axis, tiled=True)
        me = jax.lax.axis_index(mesh_axis)
        mine = (all_cnt > 0.0) & (owner_of_points(
            all_moved, n_shards, voxel_size=voxel_size,
            hierarchy_factor=hierarchy_factor) == me)
        out = vm.bulk_build(all_moved, all_cnt, mine,
                            loc.l0_data.shape[0], loc.l1_meta.shape[0],
                            voxel_size=voxel_size,
                            planarity_threshold=planarity_threshold,
                            hierarchy_factor=hierarchy_factor,
                            n_dropped=loc.n_dropped)
        return _wrap_scalars(out)

    specs = map_specs(mesh_axis)
    return jax.shard_map(kernel, mesh=mesh, in_specs=(specs,),
                         out_specs=specs, check_vma=False)(state)


def gather_state(state: vm.VoxelMapState) -> vm.VoxelMapState:
    """Fetch a sharded state to host as one pytree (debug/checkpoint)."""
    return jax.tree_util.tree_map(jax.device_get, state)
