#!/usr/bin/env python3
"""KITTI odometry CLI (reference app/kitti_lidar_odometry.cpp).

Usage: python apps/kitti_lidar_odometry.py <config.yaml> [--start N] [--end N]
       [--skip N] [--sync-loop]
"""
import argparse
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lidar_odometry_tpu.config import load_config
from lidar_odometry_tpu.io.kitti import KittiPlayer
from lidar_odometry_tpu.utils import logging_util as log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="KITTI LiDAR odometry")
    ap.add_argument("config", help="YAML config path (reference config/kitti.yaml schema)")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--sync-loop", action="store_true",
                    help="run loop closure inline (deterministic)")
    ap.add_argument("--save-map", default=None, help="save final map PLY here")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the voxel map over N devices (multi-chip "
                         "pipeline: distributed ICP + shard-local updates "
                         "+ distributed Schur PGO)")
    ap.add_argument("--live-viewer", type=int, nargs="?", const=8123,
                    default=None, metavar="PORT",
                    help="serve a live 3D view (trajectory/map/scan/"
                         "surfels/icp-debug + auto/step/finish controls) "
                         "on localhost:PORT")
    ap.add_argument("--chunk", type=int, default=None, metavar="N",
                    help="frames per fused device dispatch (the bench "
                         "single-stream fast path; default from config "
                         "chunk_frames, 0 = per-frame reference loop)")
    ap.add_argument("--prestage", action="store_true",
                    help="upload all chunks as fast as the reader allows "
                         "(bench methodology) instead of the 2-chunk "
                         "streaming bound")
    args = ap.parse_args(argv)

    print("=" * 60)
    print(" lidar_odometry_tpu — LiDAR SLAM (KITTI player)")
    print("=" * 60)

    cfg = load_config(args.config)
    player = KittiPlayer(cfg)
    lv = None
    if args.live_viewer is not None:
        from lidar_odometry_tpu.viewer import LiveViewer
        lv = LiveViewer(port=args.live_viewer)
    result = player.run(start=args.start, end=args.end, skip=args.skip,
                        sync_loop=args.sync_loop, shards=args.shards,
                        live_viewer=lv, chunk_frames=args.chunk,
                        prestage=args.prestage)
    if lv is not None:
        lv.update(player.estimator) if player.estimator else None
        lv.close()
    if result.frames_processed == 0:
        return 1

    if args.save_map and player.estimator is not None:
        from lidar_odometry_tpu.io.ply import save_ply
        save_ply(args.save_map, player.estimator.accumulated_map(cfg.map_voxel_size))
        log.info("Saved map: {}", args.save_map)

    print("-" * 60)
    print(f" Frames: {result.frames_processed}   "
          f"Time: {result.total_time_s:.1f}s   FPS: {result.fps:.1f}")
    if result.error_stats and result.error_stats.available:
        s = result.error_stats
        print(f" ATE RMSE: {s.ate_rmse:.3f} m   ATE mean: {s.ate_mean:.3f} m")
        print(f" Translation: {s.translation_mean:.2f}%   "
              f"Rotation: {s.rotation_mean:.4f} deg/100m")
    if result.trajectory_path:
        print(f" Trajectory: {result.trajectory_path}")
    print("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
