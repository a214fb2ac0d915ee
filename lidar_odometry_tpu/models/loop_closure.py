"""Loop-closure detection over LiDAR-Iris descriptors (reference
src/processing/LoopClosureDetector.{h,cpp}).

Host-side orchestration + device-side batched comparison:
  * keyframes are queued with their LOCAL-frame feature cloud and queue-time
    position (lazy feature extraction, reference LoopClosureDetector.cpp:44-73);
  * detection drains the pending queue, extracts Iris features (device),
    gates candidates by keyframe-id gap and Euclidean distance of the
    stored (possibly drifted) positions (reference :129-154 — the distance
    gate deliberately uses pre-PGO positions, SURVEY.md §7 hard part (d)),
    and scores all surviving candidates in ONE batched compare instead of
    the reference's sequential scan;
  * only the best candidate under similarity_threshold is returned
    (reference :156-175).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import iris
from ..utils import logging_util as log


@dataclass
class LoopCandidate:
    query_keyframe_id: int
    match_keyframe_id: int
    similarity_score: float
    bias: int


@dataclass
class LoopClosureConfig:
    enable_loop_detection: bool = True
    similarity_threshold: float = 0.3
    min_keyframe_gap: int = 50
    max_search_distance: float = 5.0
    enable_debug_output: bool = False


class LoopClosureDetector:
    """The descriptor DB lives ON DEVICE as three preallocated arrays
    updated in place (donated dynamic_update_slice — no functional-update
    copies; no drain-time fetches: a fetch-then-reupload DB moved every
    descriptor across the host link twice).
    Extraction writes straight into the DB rows in the same dispatch;
    a query gathers its candidates by index on device and fetches only
    the (distance, bias) score rows. The host keeps just kf_ids and
    queue-time positions for the gap/distance gates. Iris images are
    stored uint8 (8-bit occupancy masks, reference LidarIris.cpp:4-19)."""

    def __init__(self, config: LoopClosureConfig, capacity: int = 4096):
        self.config = config
        self.capacity = capacity
        self._dev_img = None        # (capacity, ROWS, COLS) uint8
        self._dev_T = None          # (capacity, PACKED_WORDS, COLS) uint32
        self._dev_M = None
        self._db_n = 0
        self._kf_ids: List[int] = []
        self._positions: List[np.ndarray] = []
        self._pending: List[tuple] = []  # (cloud np, mask np, kf_id, position)
        self.total_queries = 0
        self.total_candidates = 0

    def add_keyframe(self, cloud: np.ndarray, mask: np.ndarray, kf_id: int,
                     position: np.ndarray) -> bool:
        if cloud is None or not mask.any():
            log.warn("[LoopClosureDetector] Empty point cloud for keyframe {}", kf_id)
            return False
        self._pending.append((cloud, mask, kf_id, position.copy()))
        return True

    _DRAIN_BATCH = 16
    _MAX_CANDIDATES = 32

    def _ensure_db(self):
        # capacity+1 rows: row `capacity` is a dedicated SCRATCH row for
        # unknown-query extraction, so a full DB (db_n == capacity) never
        # has a live row overwritten by a query (round-3 advisor: the
        # old qi = min(db_n, capacity-1) permanently corrupted the
        # newest stored descriptor once the DB filled, then self-matched
        # it at similarity 0.0 — a fabricated loop constraint).
        if self._dev_img is None:
            rows = self.capacity + 1
            self._dev_img = jnp.zeros((rows, iris.ROWS, iris.COLS),
                                      jnp.uint8)
            self._dev_T = jnp.zeros(
                (rows, iris.PACKED_WORDS, iris.COLS), jnp.uint32)
            self._dev_M = jnp.zeros(
                (rows, iris.PACKED_WORDS, iris.COLS), jnp.uint32)

    @staticmethod
    @jax.jit
    def _compare_idx(dbi, dbT, dbM, qidx, cand_idx, valid):
        """Batched compare of DB row `qidx` against DB rows `cand_idx`,
        everything resident on device."""
        q_img = dbi[qidx].astype(jnp.float32)
        return iris.compare_batch_packed(
            q_img, dbT[qidx], dbM[qidx], dbi[cand_idx], dbT[cand_idx],
            dbM[cand_idx], valid)

    @staticmethod
    @partial(jax.jit, donate_argnums=(2, 3, 4))
    def _extract_store(clouds, masks, dbi, dbT, dbM, start):
        """Extract a keyframe batch AND write the descriptors into the
        device DB rows [start, start+b) in the same dispatch — nothing
        comes back to the host."""
        imgs = jax.vmap(iris.iris_image)(clouds, masks)
        _, Ts, Ms = jax.vmap(iris.iris_feature)(imgs)
        dbi = jax.lax.dynamic_update_slice(dbi, imgs.astype(jnp.uint8),
                                           (start, 0, 0))
        dbT = jax.lax.dynamic_update_slice(dbT, Ts, (start, 0, 0))
        dbM = jax.lax.dynamic_update_slice(dbM, Ms, (start, 0, 0))
        return dbi, dbT, dbM

    def _drain_pending(self):
        """Extract queued keyframes in vmapped batches straight into the
        device DB (power-of-two buckets bound the compile count to 5
        shapes; trailing pad rows are overwritten by the next drain and
        masked out of every compare by db_n)."""
        while self._pending:
            room = self.capacity - self._db_n
            if room <= 0:
                for _c, _m, kf_id, _p in self._pending:
                    log.warn("[LoopClosureDetector] DB capacity exceeded, "
                             "dropping KF {}", kf_id)
                self._pending = []
                break
            # power-of-two bucket that always fits the remaining room, so
            # the update block starts exactly at db_n (pad rows land past
            # the live region, never over it)
            b = 1
            while (b * 2 <= room
                   and b < min(len(self._pending), self._DRAIN_BATCH)):
                b *= 2
            take = min(b, len(self._pending))
            batch = self._pending[:take]
            self._pending = self._pending[take:]
            k = len(batch)
            clouds = np.stack([x[0] for x in batch] + [batch[0][0]] * (b - k))
            masks = np.stack([x[1] for x in batch] + [batch[0][1]] * (b - k))
            self._ensure_db()
            start = self._db_n
            self._dev_img, self._dev_T, self._dev_M = self._extract_store(
                jnp.asarray(clouds), jnp.asarray(masks),
                self._dev_img, self._dev_T, self._dev_M, jnp.int32(start))
            for j in range(k):
                _, _, kf_id, position = batch[j]
                self._kf_ids.append(kf_id)
                self._positions.append(position)
                self._db_n += 1

    def detect_loop_closures(self, query_cloud: np.ndarray, query_mask: np.ndarray,
                             query_kf_id: int,
                             query_position: np.ndarray) -> List[LoopCandidate]:
        if not self.config.enable_loop_detection:
            return []
        self.total_queries += 1
        self._drain_pending()
        if self._db_n == 0:
            return []

        # The query keyframe was just drained into the DB — its
        # descriptor is read by index on device; a query for an unknown
        # keyframe (not produced by the pipeline) extracts past the live
        # region: row db_n while the DB has room, the dedicated scratch
        # row `capacity` once it is full. Never a row < db_n.
        if query_kf_id in self._kf_ids:
            qi = self._kf_ids.index(query_kf_id)
        else:
            self._ensure_db()
            qi = min(self._db_n, self.capacity)
            self._dev_img, self._dev_T, self._dev_M = self._extract_store(
                jnp.asarray(query_cloud)[None], jnp.asarray(query_mask)[None],
                self._dev_img, self._dev_T, self._dev_M, jnp.int32(qi))

        ids = np.asarray(self._kf_ids[: self._db_n])
        pos = np.stack(self._positions[: self._db_n])
        gap_ok = (query_kf_id - ids) >= self.config.min_keyframe_gap
        dist = np.linalg.norm(pos - query_position[None, :], axis=-1)
        dist_ok = dist <= self.config.max_search_distance
        cand_idx = np.nonzero(gap_ok & dist_ok)[0]
        if len(cand_idx) == 0:
            return []

        # Nearest-K candidate cap: on dense revisits the distance gate
        # can pass 100+ keyframes, and an unbounded power-of-two pad
        # compiled a fresh compare mid-run (one compile each for pads
        # 32/64/128). The K spatially nearest candidates bound the
        # compare to warmed buckets; the reference's own candidate gate
        # is the same distance test (LoopClosureDetector.cpp:129-154),
        # so the K nearest are exactly the most loop-plausible ones.
        if len(cand_idx) > self._MAX_CANDIDATES:
            order = np.argsort(dist[cand_idx])[: self._MAX_CANDIDATES]
            cand_idx = cand_idx[np.sort(order)]
        pad = 1
        while pad < len(cand_idx):
            pad *= 2
        idx_p = np.zeros(pad, np.int32)
        idx_p[: len(cand_idx)] = cand_idx
        valid = np.zeros(pad, bool)
        valid[: len(cand_idx)] = True

        # Candidates gather ON DEVICE by index (the only uploads are the
        # tiny index/valid vectors) and the (distance, bias) results come
        # back in ONE packed fetch.
        out = np.asarray(self._compare_idx(
            self._dev_img, self._dev_T, self._dev_M, jnp.int32(qi),
            jnp.asarray(idx_p), jnp.asarray(valid)))
        dists = out[:, 0]
        biases = out[:, 1].astype(np.int32)
        best = int(np.argmin(dists))
        best_score = float(dists[best])
        if not np.isfinite(best_score) or best_score > self.config.similarity_threshold:
            return []
        match_id = int(ids[idx_p[best]])
        self.total_candidates += 1
        if self.config.enable_debug_output:
            log.debug("[LoopClosureDetector] {} <-> {} (distance: {:.4f}, bias: {})",
                      query_kf_id, match_id, best_score, int(biases[best]))
        return [LoopCandidate(query_kf_id, match_id, best_score, int(biases[best]))]

    def clear(self):
        # keep the device DB arrays allocated: rows past db_n are dead,
        # and reallocating ~90 MB per Estimator.reset() is pure waste
        self._db_n = 0
        self._kf_ids = []
        self._positions = []
        self._pending = []
        self.total_queries = 0
        self.total_candidates = 0

    # ------------------------------------------------------------------
    # checkpoint support (the round-1 resume silently lost loop-closure
    # ability against pre-checkpoint keyframes)
    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        """Descriptor DB as arrays for checkpointing (pending queue is
        drained first so nothing is lost). The only fetches of the
        device-resident DB happen here, at checkpoint time."""
        self._drain_pending()
        n = self._db_n
        return {
            "iris_img": (np.asarray(self._dev_img)[:n] if n else
                         np.zeros((0, iris.ROWS, iris.COLS), np.uint8)),
            "iris_T": (np.asarray(self._dev_T)[:n] if n else
                       np.zeros((0, iris.PACKED_WORDS, iris.COLS), np.uint32)),
            "iris_M": (np.asarray(self._dev_M)[:n] if n else
                       np.zeros((0, iris.PACKED_WORDS, iris.COLS), np.uint32)),
            "iris_kf_ids": np.asarray(self._kf_ids, np.int32),
            "iris_positions": (np.stack(self._positions) if n else
                               np.zeros((0, 3), np.float32)),
        }

    def import_state(self, state: dict) -> None:
        self.clear()
        n = len(state["iris_kf_ids"])
        if n > self.capacity:
            # keep host ids/positions and device rows in lockstep: a
            # kf_id kept past a truncated device row would clamp-gather
            # the wrong descriptor (round-3 advisor finding)
            log.warn("[LoopClosureDetector] checkpoint has {} descriptors, "
                     "capacity {}: truncating", n, self.capacity)
        n_used = min(n, self.capacity)
        if n_used:
            self._ensure_db()
            pad = self.capacity + 1 - n_used
            self._dev_img = jnp.asarray(np.concatenate(
                [state["iris_img"][:n_used],
                 np.zeros((pad, iris.ROWS, iris.COLS), np.uint8)]))
            self._dev_T = jnp.asarray(np.concatenate(
                [state["iris_T"][:n_used],
                 np.zeros((pad, iris.PACKED_WORDS, iris.COLS),
                          np.uint32)]))
            self._dev_M = jnp.asarray(np.concatenate(
                [state["iris_M"][:n_used],
                 np.zeros((pad, iris.PACKED_WORDS, iris.COLS),
                          np.uint32)]))
        self._kf_ids = [int(k) for k in state["iris_kf_ids"][:n_used]]
        self._positions = [state["iris_positions"][i] for i in range(n_used)]
        self._db_n = n_used
