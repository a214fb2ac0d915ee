#!/usr/bin/env python3
"""Diagnose accepted-loop T_rel accuracy on the bench ring circuit
(round-4 VERDICT weak item 1): run the loop-enabled workload in
deterministic sync mode, record every accepted loop's between-factor
T_matched_to_current, and compare with synthetic ground truth. Prints a
per-loop error table plus the trajectory ATE evolution, so the ATE
regression can be attributed to the loop factors vs PGO/rehash effects.
"""
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bench  # noqa: E402
from lidar_odometry_tpu.config import SystemConfig  # noqa: E402
from lidar_odometry_tpu.eval import ate_rmse  # noqa: E402
from lidar_odometry_tpu.models.estimator import Estimator  # noqa: E402


def main():
    n_frames, cap = 750, 16384
    cache = os.path.join(tempfile.gettempdir(),
                         f"bench_rings_{bench._generator_tag()}_{n_frames}_{cap}.npz")
    d = np.load(cache)
    scans, gt = d["scans"], d["poses"]

    cfg = SystemConfig(
        scan_capacity=8192, map_l0_capacity=262144,
        map_l1_capacity=65536, keyframe_capacity=1024, point_stride=1,
        voxel_size=0.5, map_voxel_size=0.5, max_range=100.0,
        enable_loop_detection=True, min_keyframe_gap=40,
        max_search_distance=6.0, similarity_threshold=0.35,
        enable_console_statistics=False)
    est = Estimator(cfg, sync_loop=True)

    loops = []
    orig = est.pose_graph.add_loop_and_optimize

    def spy(m_id, c_id, T_m2c, tn, rn):
        m_kf = next(k for k in est.keyframes if k.kf_id == m_id)
        c_kf = next(k for k in est.keyframes if k.kf_id == c_id)
        gt_m = gt[m_kf.frame_index].astype(np.float64)
        gt_c = gt[c_kf.frame_index].astype(np.float64)
        T_true = np.linalg.inv(gt_m) @ gt_c
        E = np.linalg.inv(T_true) @ T_m2c
        t_err = float(np.linalg.norm(E[:3, 3]))
        ang = float(np.degrees(np.arccos(np.clip(
            (np.trace(E[:3, :3]) - 1) / 2, -1, 1))))
        loops.append((c_id, m_id, t_err, ang, tn))
        print(f"  loop {c_id:4d}<->{m_id:4d}: T_rel err "
              f"{t_err*1e3:7.2f} mm  {ang:6.4f} deg   noise_t {tn:.2f}",
              flush=True)
        return orig(m_id, c_id, T_m2c, tn, rn)

    est.pose_graph.add_loop_and_optimize = spy

    CH = 25
    t0 = time.perf_counter()
    for c in range(0, n_frames, CH):
        est.process_chunk(scans[c:c + CH])
    est.finalize_loops()
    print(f"wall {time.perf_counter()-t0:.1f}s")
    err = ate_rmse(est.trajectory(), np.asarray(gt))
    print(f"ATE(on,sync) = {err:.4f} m over {est.loop_constraint_count} loops")
    if loops:
        errs = np.array([l[2] for l in loops])
        print(f"T_rel err mean/max = {errs.mean()*1e3:.2f}/"
              f"{errs.max()*1e3:.2f} mm")
    est.shutdown()


if __name__ == "__main__":
    main()
