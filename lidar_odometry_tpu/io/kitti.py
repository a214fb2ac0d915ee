"""KITTI dataset player + trajectory writer (reference
app/player/kitti_player.{h,cpp}).

Drives the estimator over a sequence of KITTI velodyne .bin files,
synthesizes 10 Hz timestamps, saves the trajectory in KITTI (camera-frame,
reference kitti_player.cpp:934-954) or TUM format, and evaluates against
ground truth with the reference's segment-based evaluator (eval.py).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..config import SystemConfig
from ..eval import ErrorStats, T_LIDAR_TO_CAM, evaluate_trajectory, lidar_pose_to_cam
from ..models.estimator import Estimator
from ..utils import logging_util as log
from ..runtime import native_io


def load_kitti_binary(path: str) -> np.ndarray:
    """(N, 3) float32 from a KITTI .bin (x, y, z, intensity float4;
    intensity dropped — reference PointCloudUtils.cpp:19-65). Uses the
    native C++ loader when available."""
    return native_io.load_kitti_binary(path)


def parse_kitti_pose_line(line: str) -> np.ndarray:
    vals = [float(v) for v in line.split()]
    T = np.eye(4, dtype=np.float64)
    T[:3, :4] = np.asarray(vals, np.float64).reshape(3, 4)
    return T


def load_kitti_gt(path: str) -> np.ndarray:
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                poses.append(parse_kitti_pose_line(line))
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


def pose_to_kitti_string(pose: np.ndarray) -> str:
    """LiDAR-frame pose -> camera-frame 3x4 row (reference
    pose_to_kitti_string, kitti_player.cpp:934-954)."""
    cp = lidar_pose_to_cam(pose.astype(np.float64))
    return " ".join(f"{cp[r, c]:.9f}" for r in range(3) for c in range(4))


def save_trajectory_kitti(path: str, poses: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for pose in poses:
            f.write(pose_to_kitti_string(pose) + "\n")
    log.info("[KittiPlayer] Saved trajectory: {}", path)


def save_trajectory_tum(path: str, poses: np.ndarray, rate_hz: float = 10.0):
    """TUM format: t x y z qx qy qz qw (reference kitti_player.cpp:548-574)."""
    from scipy.spatial.transform import Rotation
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i, pose in enumerate(poses):
            q = Rotation.from_matrix(pose[:3, :3]).as_quat()  # x y z w
            t = pose[:3, 3]
            f.write(f"{i / rate_hz:.6f} {t[0]:.8f} {t[1]:.8f} {t[2]:.8f} "
                    f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}\n")


@dataclass
class VelocityStats:
    """reference analyze_velocity_statistics (kitti_player.cpp:759-811)."""
    available: bool = False
    linear_mean: float = 0.0
    linear_max: float = 0.0
    angular_mean: float = 0.0   # deg/s
    angular_max: float = 0.0


def velocity_statistics(poses: np.ndarray, rate_hz: float = 10.0) -> VelocityStats:
    stats = VelocityStats()
    if len(poses) < 2:
        return stats
    dt = 1.0 / rate_hz
    lin, ang = [], []
    for i in range(1, len(poses)):
        dp = poses[i][:3, 3] - poses[i - 1][:3, 3]
        lin.append(np.linalg.norm(dp) / dt)
        R_rel = poses[i - 1][:3, :3].T @ poses[i][:3, :3]
        c = np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)
        ang.append(np.degrees(np.arccos(c)) / dt)
    stats.available = True
    stats.linear_mean = float(np.mean(lin))
    stats.linear_max = float(np.max(lin))
    stats.angular_mean = float(np.mean(ang))
    stats.angular_max = float(np.max(ang))
    return stats


@dataclass
class KittiPlayerResult:
    frames_processed: int = 0
    total_time_s: float = 0.0
    fps: float = 0.0
    # chunked mode: throughput after the first (warmup/compile) chunk —
    # the number comparable to the bench's single-stream methodology,
    # which also excludes its compile chunk from the timed region
    steady_fps: float = 0.0
    error_stats: Optional[ErrorStats] = None
    velocity_stats: Optional[VelocityStats] = None
    trajectory_path: str = ""
    statistics_path: str = ""
    per_frame_ms: List[float] = field(default_factory=list)


def save_statistics(path: str, result: "KittiPlayerResult", seq: str):
    """Run-statistics file (reference save_statistics,
    kitti_player.cpp:813-890)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("=== lidar_odometry_tpu run statistics ===\n")
        f.write(f" Sequence: {seq}\n")
        f.write(f" Frames processed: {result.frames_processed}\n")
        f.write(f" Total time: {result.total_time_s:.2f} s\n")
        f.write(f" Average FPS: {result.fps:.2f}\n")
        if result.steady_fps > 0:
            f.write(f" Steady FPS (post-warmup): {result.steady_fps:.2f}\n")
        if result.per_frame_ms:
            arr = np.asarray(result.per_frame_ms)
            f.write(f" Frame time avg/min/max: {arr.mean():.2f} / "
                    f"{arr.min():.2f} / {arr.max():.2f} ms\n")
        if result.error_stats and result.error_stats.available:
            s = result.error_stats
            f.write(f" ATE RMSE: {s.ate_rmse:.4f} m\n")
            f.write(f" ATE mean/median: {s.ate_mean:.4f} / {s.ate_median:.4f} m\n")
            f.write(f" Translation error: {s.translation_mean:.3f} %\n")
            f.write(f" Rotation error: {s.rotation_mean:.5f} deg/100m\n")
            f.write(f" Segments evaluated: {s.total_segments}\n")
            f.write(f" Scale factor: {s.scale_factor:.6f}\n")
        if result.velocity_stats and result.velocity_stats.available:
            v = result.velocity_stats
            f.write(f" Linear velocity avg/max: {v.linear_mean:.2f} / "
                    f"{v.linear_max:.2f} m/s\n")
            f.write(f" Angular velocity avg/max: {v.angular_mean:.2f} / "
                    f"{v.angular_max:.2f} deg/s\n")


class KittiPlayer:
    """reference KittiPlayer::run/run_from_yaml (kitti_player.cpp:39-292)."""

    def __init__(self, config: SystemConfig):
        self.cfg = config
        self.estimator: Optional[Estimator] = None

    def bin_files(self) -> List[str]:
        """Sorted .bin enumeration (reference get_bin_files,
        kitti_player.cpp:892-910)."""
        d = os.path.join(self.cfg.data_directory, "sequences", self.cfg.seq,
                         "velodyne")
        if not os.path.isdir(d):
            d = self.cfg.data_directory
        if not os.path.isdir(d):
            return []
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".bin")]

    def gt_path(self) -> Optional[str]:
        if not self.cfg.ground_truth_directory:
            return None
        p = os.path.join(self.cfg.ground_truth_directory, f"{self.cfg.seq}.txt")
        return p if os.path.isfile(p) else None

    def run(self, start: int = 0, end: Optional[int] = None, skip: int = 1,
            sync_loop: bool = False, prefetch: bool = True,
            shards: int = 0, live_viewer=None,
            chunk_frames: Optional[int] = None,
            prestage: bool = False) -> KittiPlayerResult:
        """`shards` > 0 runs the SAME pipeline with the voxel map sharded
        over that many devices (BASELINE config 5: distributed robust
        ICP, shard-local updates, distributed Schur PGO), via
        models/map_backend.ShardedMapBackend.

        `live_viewer` — a viewer.LiveViewer: the frame loop then honors
        its auto/step/finish controls and pushes a state snapshot every
        few frames (the reference player's viewer handoff,
        kitti_player.cpp:428-511).

        `chunk_frames` (None -> config.chunk_frames): >1 routes the run
        through the fused chunk path (Estimator.process_chunk — the
        bench single-stream engine) with the background chunk feeder
        (io/feeder.py); <=1 is the reference's per-frame loop. The
        sharded backend always uses the per-frame front door. In chunked
        mode the stride-skip decimation happens at decode time and the
        estimator's filter runs with stride 1 (identical semantics,
        stride-x smaller uploads — io/feeder.py). `prestage` uploads all
        chunks as fast as the reader allows (bench methodology; the
        default streams with a 2-chunk bound)."""
        result = KittiPlayerResult()
        files = self.bin_files()
        if not files:
            log.error("[KittiPlayer] No .bin files found under {}", self.cfg.data_directory)
            return result
        files = files[start:end:skip]
        log.info("[KittiPlayer] {} frames (seq {})", len(files), self.cfg.seq)

        backend = None
        if shards > 0:
            from ..models.map_backend import ShardedMapBackend
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(shards, ("map",))
            self.cfg = self.cfg.replace(pgo_backend="distributed")
            backend = ShardedMapBackend(self.cfg, mesh)
            log.info("[KittiPlayer] sharded map over {} devices", shards)
        if chunk_frames is None:
            chunk_frames = self.cfg.chunk_frames
        use_chunked = bool(chunk_frames and chunk_frames > 1
                           and backend is None)
        est_cfg = self.cfg
        if use_chunked and self.cfg.point_stride > 1:
            # stride-skip moves to decode time (io/feeder.py)
            est_cfg = self.cfg.replace(point_stride=1)
        self.estimator = Estimator(est_cfg, sync_loop=sync_loop,
                                   map_backend=backend)
        if use_chunked:
            self._run_chunked(files, int(chunk_frames), live_viewer, result,
                              prestage=prestage)
        else:
            self._run_frames(files, prefetch, live_viewer, result)
        self.estimator.finalize_loops()

        traj = self.estimator.trajectory()
        if self.cfg.save_trajectory and self.cfg.output_directory:
            out_dir = os.path.join(self.cfg.output_directory, self.cfg.seq)
            fname = f"{self.cfg.seq}_lo_tpu.txt"
            result.trajectory_path = os.path.join(out_dir, fname)
            if self.cfg.trajectory_format == "tum":
                save_trajectory_tum(result.trajectory_path, traj)
            else:
                save_trajectory_kitti(result.trajectory_path, traj)

        gt_file = self.gt_path()
        if gt_file is not None:
            gt = load_kitti_gt(gt_file)
            est_cam = np.stack([lidar_pose_to_cam(p.astype(np.float64)) for p in traj])
            result.error_stats = evaluate_trajectory(est_cam, gt)
            s = result.error_stats
            log.info("[KittiPlayer] ATE RMSE {:.3f} m | trans {:.2f}% | rot {:.3f} deg/100m",
                     s.ate_rmse, s.translation_mean, s.rotation_mean)
        result.velocity_stats = velocity_statistics(traj)

        if self.cfg.enable_statistics and self.cfg.output_directory:
            result.statistics_path = os.path.join(
                self.cfg.output_directory, self.cfg.seq,
                f"{self.cfg.seq}_statistics.txt")
            save_statistics(result.statistics_path, result, self.cfg.seq)
        self.estimator.shutdown()
        return result

    def _run_frames(self, files, prefetch, live_viewer,
                    result: KittiPlayerResult):
        """The reference's per-frame loop (kitti_player.cpp:79-150)."""
        loader = native_io.Prefetcher(files) if prefetch else None
        t_run = time.perf_counter()
        for i, path in enumerate(files):
            if live_viewer is not None and not live_viewer.wait_if_stepping():
                log.info("[KittiPlayer] finish requested by viewer")
                break
            t0 = time.perf_counter()
            cloud = loader.next() if loader else load_kitti_binary(path)
            try:
                self.estimator.process_frame(cloud)
            except Exception as e:  # per-frame try/catch (ply_player.cpp:513-515)
                log.error("[KittiPlayer] frame {} failed: {}", i, repr(e))
            result.per_frame_ms.append((time.perf_counter() - t0) * 1e3)
            if live_viewer is not None and (i % 5 == 0
                                            or live_viewer.mode == "step"):
                live_viewer.update(self.estimator)
        result.total_time_s = time.perf_counter() - t_run
        # count actual loop iterations — the viewer's finish control can
        # break out early (round-4 ADVICE 1)
        result.frames_processed = len(result.per_frame_ms)
        result.fps = result.frames_processed / max(result.total_time_s, 1e-9)

    def _run_chunked(self, files, chunk_frames: int, live_viewer,
                     result: KittiPlayerResult, prestage: bool = False):
        """The production fast path: full chunks through the fused device
        pipeline (Estimator.process_chunk), scans decoded + staged by the
        background feeder; the tail remainder runs per-frame. Viewer
        controls act at chunk granularity. Stage timings are sampled
        every 8th chunk so the reference's per-stage table stays
        populated (Estimator.process_chunk sample_stages)."""
        from .feeder import ChunkFeeder
        if self.cfg.enable_loop_detection:
            self.estimator.warm_loop_programs()
        feeder = ChunkFeeder(files, chunk_frames,
                             point_stride=self.cfg.point_stride,
                             prestage=prestage)
        log.info("[KittiPlayer] chunked mode: {} chunks of {} frames, "
                 "raw capacity {}", feeder.n_chunks, chunk_frames,
                 feeder.capacity)
        source = feeder
        if prestage:
            # bench methodology: decode + upload everything BEFORE the
            # frame loop, so the measured region is compute + bookkeeping
            import jax as _jax
            source = list(feeder)
            if source:
                _jax.block_until_ready(source[-1])
            log.info("[KittiPlayer] prestaged {} chunks on device",
                     len(source))
        # With loops off and no interactive viewer, host bookkeeping
        # defers entirely: chunks dispatch back-to-back with zero host
        # round trips (the bench single-stream methodology), and the
        # deferred packed results drain in batches. Loop detection (and
        # a live viewer) need per-chunk host state, so they fetch every
        # chunk.
        defer = (not self.cfg.enable_loop_detection
                 and live_viewer is None)
        frames_done = 0
        drain_thread = None

        def drain_async():
            # Periodic drains run on a background thread so their fetch
            # round trips overlap the (async) chunk dispatch loop —
            # sequential drains (joined before starting the next) keep
            # bookkeeping in order, and the dispatch loop never reads
            # the host mirrors the drain writes while the device carry
            # is live.
            nonlocal drain_thread
            if drain_thread is not None:
                drain_thread.join()
            import threading
            drain_thread = threading.Thread(
                target=self.estimator.drain_chunks, daemon=True)
            drain_thread.start()

        t_run = time.perf_counter()
        t_steady = None
        try:
            for c, chunk in enumerate(source):
                if (live_viewer is not None
                        and not live_viewer.wait_if_stepping()):
                    log.info("[KittiPlayer] finish requested by viewer")
                    break
                t0 = time.perf_counter()
                # chunks 0-1 run synchronously: chunk 0 (full F) and
                # chunk 1 (stage-sampled, so F-1 fused frames plus one
                # per-frame pass) absorb the compiles/cache-loads of BOTH
                # fused shapes and of the per-frame programs plus the
                # first fetch; steady_fps then measures the same
                # post-warmup region as the bench. (Sampling chunk 0
                # would not do: its first frame only seeds the map, so
                # the per-frame ICP would compile inside the steady
                # region, at chunk 8.)
                self.estimator.process_chunk(
                    chunk, sample_stages=(c % 8 == 1),
                    defer_host=defer and c > 1)
                if c == 1:
                    t_steady = time.perf_counter()
                elif defer and c > 1 and (c + 1) % 16 == 0:
                    drain_async()                   # bound device refs
                per_frame = (time.perf_counter() - t0) * 1e3 / chunk_frames
                result.per_frame_ms.extend([per_frame] * chunk_frames)
                frames_done += chunk_frames
                if live_viewer is not None:
                    live_viewer.update(self.estimator)
            if drain_thread is not None:
                drain_thread.join()
            if defer:
                self.estimator.drain_chunks()
        finally:
            feeder.close()
        if t_steady is not None and frames_done > 2 * chunk_frames:
            result.steady_fps = ((frames_done - 2 * chunk_frames)
                                 / max(time.perf_counter() - t_steady, 1e-9))
        for path in feeder.tail:     # remainder < one chunk: per-frame
            t0 = time.perf_counter()
            try:
                self.estimator.process_frame(
                    load_kitti_binary(path)[::max(self.cfg.point_stride, 1)])
            except Exception as e:
                log.error("[KittiPlayer] frame failed: {}", repr(e))
            result.per_frame_ms.append((time.perf_counter() - t0) * 1e3)
            frames_done += 1
        result.total_time_s = time.perf_counter() - t_run
        result.frames_processed = frames_done
        result.fps = frames_done / max(result.total_time_s, 1e-9)


def run_from_yaml(config_path: str, **kw) -> KittiPlayerResult:
    from ..config import load_config
    cfg = load_config(config_path)
    return KittiPlayer(cfg).run(**kw)
