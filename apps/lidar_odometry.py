#!/usr/bin/env python3
"""PLY-dataset odometry CLI (reference app/lidar_odometry.cpp) for
MID360-style datasets.

Usage: python apps/lidar_odometry.py <config.yaml> [--start N] [--end N]
       [--skip N] [--format kitti|tum] [--output DIR] [--no-viewer]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lidar_odometry_tpu.config import load_config
from lidar_odometry_tpu.io.ply import PLYPlayer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PLY LiDAR odometry")
    ap.add_argument("config")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--format", choices=["kitti", "tum"], default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--step", action="store_true", help="accepted for parity; no-op headless")
    ap.add_argument("--no-viewer", action="store_true", help="accepted for parity (always headless)")
    ap.add_argument("--sync-loop", action="store_true")
    ap.add_argument("--chunk", type=int, default=None, metavar="N",
                    help="frames per fused device dispatch (0 = per-frame)")
    ap.add_argument("--live-viewer", type=int, nargs="?", const=8123,
                    default=None, metavar="PORT",
                    help="serve a live 3D view on localhost:PORT")
    args = ap.parse_args(argv)

    print("=" * 60)
    print(" lidar_odometry_tpu — LiDAR SLAM (PLY player)")
    print("=" * 60)

    cfg = load_config(args.config)
    if args.format:
        cfg = cfg.replace(trajectory_format=args.format)
    if args.output:
        cfg = cfg.replace(output_directory=args.output)

    lv = None
    if args.live_viewer is not None:
        from lidar_odometry_tpu.viewer import LiveViewer
        lv = LiveViewer(port=args.live_viewer)
    player = PLYPlayer(cfg)
    result = player.run(start=args.start, end=args.end, skip=args.skip,
                        sync_loop=args.sync_loop, live_viewer=lv,
                        chunk_frames=args.chunk)
    if lv is not None:
        if player.estimator is not None:
            lv.update(player.estimator)
        lv.close()
    if result.frames_processed == 0:
        return 1
    print("-" * 60)
    print(f" Frames: {result.frames_processed}   "
          f"Time: {result.total_time_s:.1f}s   FPS: {result.fps:.1f}")
    if result.trajectory_path:
        print(f" Trajectory: {result.trajectory_path}")
    print("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
