#!/usr/bin/env python3
"""Loop-closure recall sweep artifact (round-3 VERDICT item 6): Iris
match-score distributions for controlled revisits at offsets 0-15 m plus
random-pair negatives, and the detection rate per threshold. Writes
RECALL.json at the repo root.

Run on the CPU or the GPU: python tools/recall_sweep.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from lidar_odometry_tpu.io import synthetic
from lidar_odometry_tpu.ops import iris

CAP = 16384
OFFSETS = [0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 15.0]
THRESHOLDS = [0.25, 0.3, 0.35, 0.4, 0.45]
N_SPOTS = 8


def pose_at(x, y, yaw):
    p = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    p[:2, :2] = [[c, -s], [s, c]]
    p[0, 3], p[1, 3], p[2, 3] = x, y, 1.7
    return p


def desc(world, pose, rng):
    s = synthetic.sample_scan_rings(world, pose, rng, n_rings=32,
                                    azimuth_steps=512, max_range=70.0,
                                    noise=0.01)
    pts = np.full((CAP, 3), np.nan, np.float32)
    pts[: min(len(s), CAP)] = s[:CAP]
    m = np.isfinite(pts[:, 0])
    pts = np.where(m[:, None], pts, 0.0)
    img = iris.iris_image(jnp.asarray(pts), jnp.asarray(m))
    _, T, M = iris.iris_feature(img)
    return img, T, M


def score(a, b):
    out = np.asarray(iris.compare_batch_packed(
        a[0].astype(jnp.float32), a[1], a[2],
        b[0][None].astype(jnp.uint8), b[1][None], b[2][None],
        jnp.ones(1, bool)))
    return float(out[0, 0])


def main():
    world = synthetic.make_world(seed=5, extent=100.0, n_buildings=30)
    rng = np.random.default_rng(5)
    spots = [(rng.uniform(-38, 38), rng.uniform(-38, 38))
             for _ in range(N_SPOTS)]
    result = {"offsets_m": OFFSETS, "thresholds": THRESHOLDS,
              "n_pairs_per_offset": N_SPOTS, "scores": {},
              "recall": {}, "negatives": []}
    for d in OFFSETS:
        scores = []
        for cx, cy in spots:
            a = desc(world, pose_at(cx, cy, rng.uniform(0, 6)), rng)
            ang = rng.uniform(0, 2 * np.pi)
            b = desc(world, pose_at(cx + d * np.cos(ang),
                                    cy + d * np.sin(ang),
                                    rng.uniform(0, 2 * np.pi)), rng)
            scores.append(round(score(a, b), 4))
        result["scores"][str(d)] = scores
        result["recall"][str(d)] = {
            str(t): round(sum(s < t for s in scores) / len(scores), 3)
            for t in THRESHOLDS}
        print(f"# offset {d:5.1f} m: median {np.median(scores):.3f} "
              f"recall@0.35 {result['recall'][str(d)]['0.35']}",
              file=sys.stderr)
    for _ in range(N_SPOTS):
        a = desc(world, pose_at(rng.uniform(-40, 40), rng.uniform(-40, 40),
                                rng.uniform(0, 6)), rng)
        b = desc(world, pose_at(rng.uniform(-40, 40), rng.uniform(-40, 40),
                                rng.uniform(0, 6)), rng)
        result["negatives"].append(round(score(a, b), 4))
    result["false_accepts"] = {
        str(t): round(sum(s < t for s in result["negatives"])
                      / len(result["negatives"]), 3)
        for t in THRESHOLDS}
    result["note"] = (
        "Iris is yaw-invariant but not translation-invariant: revisits "
        "within ~2-3 m score well below the 0.35 threshold, by ~5 m the "
        "occupancy image has decorrelated into the random-pair band. The "
        "position gate (max_search_distance) carries detection beyond "
        "that, which couples recall to odometry quality - the same "
        "trade the reference makes (LoopClosureDetector.cpp:139-144).")
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "RECALL.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"# wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
