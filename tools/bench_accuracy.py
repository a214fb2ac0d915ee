#!/usr/bin/env python3
"""Accuracy benchmark over the full pipeline (VERDICT items 5 + 6).

Four workloads, all >=900 frames through the real front door, written to
ACCURACY.json at the repo root:

  * odometry_only / loop_closure — the KITTI-07-shaped stadium circuit
    at the reference's KITTI operating point (surfel correspondences,
    config/kitti.yaml), driven with HARDENED synthetic data: spinning
    64-ring ray-cast scans (HDL-64E beam model), ~5% dynamic points
    (moving boxes), and non-planar clutter blobs that stress the surfel
    planarity rejection (VoxelMap.cpp:244-253).
  * kdtree_mode — BASELINE config 1: the same circuit with
    use_surfel_correspondence=false (grid-kNN + plane fit replacing the
    reference's KD-tree path, config/kitti.yaml:60 flipped).
  * mid360_indoor — BASELINE config 3: an indoor corridor loop with
    MID360-style scans (wide-FOV rings, ceiling+floor), stride 4,
    0.4 m voxels, KD-tree correspondences, PKO on
    (config/mid360.yaml:17-19,60).

Reports the reference evaluator's segment errors (trans %/rot deg/100 m,
app/player/kitti_player.cpp:576-757), ATE, loop statistics, throughput.
"""
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_FRAMES = 1280
RAW_N = 65536          # scan pad (ring caster returns ~55k points)
CHUNK = 20
N_FRAMES_INDOOR = 960


def _generator_tag():
    """md5 of the synthetic generator source: a generator change
    regenerates the cached workloads instead of silently reusing last
    round's (round-4 VERDICT weak item 7)."""
    import hashlib
    from lidar_odometry_tpu.io import synthetic
    with open(synthetic.__file__, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()[:10]


def make_scans():
    """Hardened outdoor circuit: ray-cast 64-ring scans + 12 moving boxes
    + 40 clutter blobs (cached; ~25 min to generate once)."""
    from lidar_odometry_tpu.io import synthetic
    cache = os.path.join(tempfile.gettempdir(),
                         f"acc_scans_rings_{_generator_tag()}_"
                         f"{N_FRAMES}_{RAW_N}.npz")
    if os.path.exists(cache):
        d = np.load(cache)
        return d["scans"], d["poses"], float(d["dyn_frac"])
    world = synthetic.make_world(seed=21, extent=130.0, n_buildings=40)
    poses = synthetic.circuit_trajectory(N_FRAMES, length=120.0, radius=25.0,
                                         step=0.65)
    objs = synthetic.make_dynamic_objects(21, 40, extent=100.0,
                                          near_path=poses[::16, :2, 3])
    clut = synthetic.make_clutter(21, 40, extent=100.0)
    rng = np.random.default_rng(21)
    scans = np.full((N_FRAMES, RAW_N, 3), np.nan, np.float32)
    dyn_hits = tot_hits = 0
    t0 = time.time()
    for i in range(N_FRAMES):
        s, dyn = synthetic.sample_scan_rings(
            world, poses[i], rng, n_rings=64, azimuth_steps=900,
            max_range=80.0, noise=0.01, dynamic_objects=objs, t=float(i),
            clutter=clut, return_dynamic_mask=True)
        dyn_hits += int(dyn.sum())
        tot_hits += len(s)
        scans[i, : min(len(s), RAW_N)] = s[:RAW_N]
        if i % 100 == 0:
            print(f"#   scan {i}/{N_FRAMES} ({time.time()-t0:.0f}s)",
                  file=sys.stderr)
    dyn_frac = dyn_hits / max(tot_hits, 1)
    try:
        np.savez(cache, scans=scans, poses=poses, dyn_frac=dyn_frac)
    except Exception:
        pass
    return scans, poses, dyn_frac


def make_indoor_scans():
    """MID360-style corridor loop: wide-FOV ring scans with ceiling."""
    from lidar_odometry_tpu.io import synthetic
    cache = os.path.join(tempfile.gettempdir(),
                         f"acc_scans_indoor_{_generator_tag()}_"
                         f"{N_FRAMES_INDOOR}.npz")
    if os.path.exists(cache):
        d = np.load(cache)
        return d["scans"], d["poses"]
    poses = synthetic.circuit_trajectory(N_FRAMES_INDOOR, length=24.0,
                                         radius=7.0, step=0.12, height=1.2)
    center_k = synthetic.circuit_trajectory(64, length=24.0, radius=7.0,
                                            step=(2 * 24.0 + 2 * np.pi * 7.0) / 64,
                                            height=1.2)
    world = synthetic.make_corridor_world(center_k[:, :2, 3], width=5.0,
                                          height=3.0, extent=25.0)
    rng = np.random.default_rng(33)
    cap = 32768
    scans = np.full((N_FRAMES_INDOOR, cap, 3), np.nan, np.float32)
    t0 = time.time()
    for i in range(N_FRAMES_INDOOR):
        s = synthetic.sample_scan_rings(
            world, poses[i], rng, n_rings=40, azimuth_steps=720,
            max_range=25.0, noise=0.008, elevation_range=(-7.0, 52.0))
        scans[i, : min(len(s), cap)] = s[:cap]
        if i % 200 == 0:
            print(f"#   indoor scan {i}/{N_FRAMES_INDOOR} "
                  f"({time.time()-t0:.0f}s)", file=sys.stderr)
    try:
        np.savez(cache, scans=scans, poses=poses)
    except Exception:
        pass
    return scans, poses


def run(scans, enable_loop, *, surfel=True, indoor=False, use_chunks=True,
        warm=True):
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.models.estimator import Estimator
    if indoor:
        cfg = SystemConfig(
            scan_capacity=8192, map_l0_capacity=262144,
            map_l1_capacity=65536, keyframe_capacity=1024,
            point_stride=4,                      # mid360.yaml:18
            voxel_size=0.4, map_voxel_size=0.4,  # mid360.yaml:17,19
            max_range=40.0, max_iterations=4,
            use_adaptive_m_estimator=True,
            use_surfel_correspondence=False,     # mid360.yaml:60
            enable_loop_detection=enable_loop,
            min_keyframe_gap=40, max_search_distance=6.0,
            similarity_threshold=0.35,
            enable_console_statistics=False)
    else:
        cfg = SystemConfig(
            scan_capacity=14336, map_l0_capacity=262144,
            map_l1_capacity=65536, keyframe_capacity=1024, point_stride=4,
            voxel_size=0.5, map_voxel_size=0.5, max_range=100.0,
            max_iterations=4, use_adaptive_m_estimator=True,
            use_surfel_correspondence=surfel,
            enable_loop_detection=enable_loop,
            min_keyframe_gap=50, max_search_distance=10.0,
            similarity_threshold=0.35,
            enable_console_statistics=False)
    # sync_loop: loop queries + PGO run inline at chunk boundaries, so
    # the accuracy numbers are deterministic (the async worker's results
    # land at timing-dependent frames).
    est = Estimator(cfg, sync_loop=True)
    if enable_loop:
        # pre-compile the worker's device programs so the measured run is
        # steady-state, not compile-bound (round-2 VERDICT weak item 3)
        est.warm_loop_programs()
    if warm and use_chunks:
        # warm THIS configuration's chunk + per-frame programs on the
        # SAME instance, then reset the SLAM state: each (loop,
        # correspondence-mode, shapes) variant compiles its own fused
        # program, and an in-region compile (or a persistent-cache load)
        # would swamp the fps comparison.
        est.process_chunk(scans[:2 * CHUNK], sample_stages=True)
        est.reset()
    t0 = time.perf_counter()
    if use_chunks:
        for i, c in enumerate(range(0, len(scans), CHUNK)):
            # every 5th chunk samples its first frame through the
            # per-frame path so the reference's stage table stays
            # populated (Estimator.cpp:1307-1355)
            est.process_chunk(scans[c:c + CHUNK], sample_stages=(i % 5 == 0))
    else:
        for s in scans:
            est.process_frame(s, n_points=len(s))
    est.finalize_loops()
    dt = time.perf_counter() - t0
    return est, dt


def evaluate(est, dt, gt, n_frames):
    from lidar_odometry_tpu.eval import evaluate_trajectory, ate_rmse
    traj = est.trajectory()
    stats = evaluate_trajectory(traj, gt,
                                segment_lengths=[100.0, 200.0, 300.0, 400.0])
    return {
        "ate_rmse_m": round(ate_rmse(traj, gt), 4),
        "segment_translation_pct": round(stats.translation_mean, 4),
        "segment_rotation_deg_per_100m": round(stats.rotation_mean, 4),
        "segments": stats.total_segments,
        "keyframes": len(est.keyframes),
        "loop_constraints": est.loop_constraint_count,
        "loop_queries": est.loop_detector.total_queries,
        "loop_candidates": est.loop_detector.total_candidates,
        "loop_icp_attempts": est.loop_icp_attempts,
        "map_dropped": int(np.asarray(est.map_state.n_dropped).sum()),
        "wall_s": round(dt, 1),
        "fps": round(n_frames / dt, 1),
    }


def main():
    print("# generating scans...", file=sys.stderr)
    scans, gt, dyn_frac = make_scans()
    indoor_scans, indoor_gt = make_indoor_scans()

    import jax
    dev = jax.devices()[0]
    out = {"kind": "kitti07_like_accuracy",
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "frames": N_FRAMES,
           "path_length_m": round(float(np.sum(np.linalg.norm(
               np.diff(gt[:, :3, 3], axis=0), axis=-1))), 1),
           "laps": 2.1,
           "data": {"generator": "ray-cast 64-ring spinning scans",
                    "dynamic_boxes": 12,
                    "dynamic_point_fraction": round(dyn_frac, 3),
                    "clutter_blobs": 40}}
    for tag, enable in (("odometry_only", False), ("loop_closure", True)):
        est, dt = run(scans, enable)
        res = evaluate(est, dt, gt, N_FRAMES)
        out[tag] = res
        est.shutdown()
        print(f"# {tag}: ate={res['ate_rmse_m']}m "
              f"trans={res['segment_translation_pct']}% "
              f"rot={res['segment_rotation_deg_per_100m']}deg/100m "
              f"loops={res['loop_constraints']} kf={res['keyframes']} "
              f"({res['fps']} fps incl. host bookkeeping)", file=sys.stderr)

    # BASELINE config 1: KD-tree/plane-fit correspondence mode
    est, dt = run(scans, enable_loop=True, surfel=False)
    res = evaluate(est, dt, gt, N_FRAMES)
    out["kdtree_mode"] = res
    est.shutdown()
    print(f"# kdtree_mode: ate={res['ate_rmse_m']}m "
          f"loops={res['loop_constraints']} ({res['fps']} fps)",
          file=sys.stderr)

    # BASELINE config 3: MID360-style indoor corridor loop
    est, dt = run(indoor_scans, enable_loop=True, indoor=True)
    res = evaluate(est, dt, indoor_gt, N_FRAMES_INDOOR)
    out["mid360_indoor"] = res
    out["mid360_indoor"]["frames"] = N_FRAMES_INDOOR
    out["mid360_indoor"]["path_length_m"] = round(float(np.sum(
        np.linalg.norm(np.diff(indoor_gt[:, :3, 3], axis=0), axis=-1))), 1)
    est.shutdown()
    print(f"# mid360_indoor: ate={res['ate_rmse_m']}m "
          f"loops={res['loop_constraints']} ({res['fps']} fps)",
          file=sys.stderr)

    ok = (out["loop_closure"]["loop_constraints"] >= 1
          and out["loop_closure"]["ate_rmse_m"]
          <= max(out["odometry_only"]["ate_rmse_m"], 0.5)
          and out["kdtree_mode"]["ate_rmse_m"] <= 0.5
          and out["mid360_indoor"]["ate_rmse_m"] <= 0.5)
    out["pass"] = bool(ok)
    with open(os.path.join(ROOT, "ACCURACY.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
