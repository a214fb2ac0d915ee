"""Chunk feeder: background assembly + device staging of scan batches
for the players' fused chunk mode.

The reference's player loads one scan at a time on the frame loop
(reference app/player/kitti_player.cpp:79-150). The production path
processes whole (CH, N, 3) chunks per device dispatch
(Estimator.process_chunk), so the feeder pipelines the three host-side
stages against device compute:

  disk decode (native C++ double-buffered prefetcher, runtime/native_io)
    -> NaN-padded chunk assembly (numpy, this thread)
    -> host->device transfer (jax.device_put, same thread — async
       dispatch, so the upload of chunk c+1 overlaps the device compute
       of chunk c)

A bounded queue (default 2 chunks) keeps at most ~2 chunks of host RAM
in flight and throttles the reader to compute speed.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np

from ..runtime import native_io
from ..utils import logging_util as log

__all__ = ["ChunkFeeder", "ReadAhead", "raw_capacity_for"]


class ReadAhead:
    """Per-frame read-ahead for non-.bin formats (the .bin path uses the
    native C++ prefetcher): decodes the next few files on a background
    thread while the current frame is processed. Yields raw (N, 3)
    arrays; decode errors yield None for the caller's per-frame
    try/catch (reference ply_player.cpp:513-515)."""

    def __init__(self, paths: List[str], loader: Callable[[str], np.ndarray],
                 lookahead: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._n = len(paths)

        def fill():
            for p in paths:
                try:
                    self._q.put(loader(p))
                except Exception as e:
                    log.error("[feeder] decode failed for {}: {}", p, repr(e))
                    self._q.put(None)
            self._q.put(StopIteration)

        self._thread = threading.Thread(target=fill, daemon=True)
        self._thread.start()

    def __iter__(self):
        for _ in range(self._n):
            item = self._q.get()
            if item is StopIteration:
                return
            yield item


def raw_capacity_for(paths: List[str], cap_multiple: int = 2048,
                     point_stride: int = 1) -> int:
    """Fixed raw-scan pad size for a dataset: the max point count over
    the files (after decode-time striding), rounded up to a multiple
    (one compiled chunk program for the whole run — jit-stable shapes).
    KITTI .bin sizes are derivable from the file size (16 bytes/point,
    reference PointCloudUtils.cpp:19-65); other formats fall back to a
    probe load of the largest file."""
    import os
    bins = [p for p in paths if p.endswith(".bin")]
    if bins and len(bins) == len(paths):
        n_max = max(os.path.getsize(p) // 16 for p in paths)
    else:
        biggest = max(paths, key=os.path.getsize)
        from .ply import load_ply
        n_max = len(load_ply(biggest)) if biggest.endswith(".ply") \
            else native_io.load_kitti_binary(biggest).shape[0]
    n_max = -(-n_max // max(point_stride, 1))
    return int(-(-max(n_max, 1) // cap_multiple) * cap_multiple)


class ChunkFeeder:
    """Iterate (chunk_frames, raw_capacity, 3) NaN-padded scan batches
    over `paths`, assembled and (optionally) device-staged one chunk
    ahead of the consumer. Only full chunks are yielded; the remainder
    paths are exposed via `.tail` for the caller's per-frame path."""

    def __init__(self, paths: List[str], chunk_frames: int,
                 raw_capacity: Optional[int] = None,
                 loader: Optional[Callable[[str], np.ndarray]] = None,
                 stage_device: bool = True, lookahead: int = 2,
                 point_stride: int = 1, prestage: bool = False):
        """`point_stride` > 1 applies the pipeline's stride-skip
        decimation (reference FastVoxelFilter stride, VoxelMap.h:73) at
        DECODE time instead of on device — semantically identical (it is
        the filter's first op) and it shrinks the host->device upload by
        the stride factor (31 -> 3.9 MB per 20-frame KITTI chunk). The
        consumer's
        voxel filter must then run with stride 1.

        `prestage` removes the queue bound so every chunk uploads as
        fast as the reader can go — the bench methodology (scans staged
        in device memory before the timed loop); default streams with a
        2-chunk bound."""
        n_full = (len(paths) // chunk_frames) * chunk_frames
        self.paths = list(paths[:n_full])
        self.tail = list(paths[n_full:])
        self.chunk_frames = chunk_frames
        self.point_stride = max(int(point_stride), 1)
        self.capacity = raw_capacity or raw_capacity_for(
            paths, point_stride=self.point_stride)
        self.stage_device = stage_device
        self.n_chunks = len(self.paths) // chunk_frames
        self._loader = loader
        self._q = queue.Queue(maxsize=(self.n_chunks + 1 if prestage
                                       else lookahead))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        native = None
        loader = self._loader
        if loader is None:
            # .bin datasets ride the native double-buffered prefetcher
            if self.paths and self.paths[0].endswith(".bin"):
                native = native_io.Prefetcher(self.paths)
            else:
                loader = native_io.load_kitti_binary
        try:
            for c in range(self.n_chunks):
                if self._stop.is_set():
                    return
                buf = np.full((self.chunk_frames, self.capacity, 3),
                              np.nan, np.float32)
                for i in range(self.chunk_frames):
                    cloud = (native.next() if native is not None
                             else loader(self.paths[c * self.chunk_frames + i]))
                    if cloud is None:
                        continue
                    if self.point_stride > 1:
                        cloud = cloud[::self.point_stride]
                    n = min(len(cloud), self.capacity)
                    buf[i, :n] = cloud[:n]
                if self.stage_device:
                    import jax.numpy as jnp
                    out = jnp.asarray(buf)   # async dispatch: upload
                else:                        # overlaps device compute
                    out = buf
                self._q.put(out)
            self._q.put(None)
        except Exception as e:  # surface decode errors, end the stream
            log.error("[feeder] chunk assembly failed: {}", repr(e))
            try:
                self._q.put(None)
            except Exception:
                pass
        finally:
            if native is not None:
                native.close()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
