#!/usr/bin/env python3
"""Smoke test of the SLAM system on NVIDIA GPUs.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: sharded map vs one card

Runs only where JAX finds a GPU: on any other platform, or outside a
checkout of this repository, it exits non-zero before printing a result.
Every phase prints one line with its result, its wall time and the card's
name and power limit; a failed check raises, so the script exits non-zero
without the final line.

One-card phases:
  1. parity at real widths against the plain references: the voxel
     filter on a 131072-point scan against a float64 per-voxel mean; map
     update + surfel lookup at the config/kitti.yaml capacities against
     the dict oracle of tests/test_voxel_map_oracle.py; the ICP normal
     equations against float64; the grid k-NN neighbour rows against a
     brute-force 5x5x5 neighbourhood; the distributed Schur PGO (float64
     on the card) against the host float64 solver;
  2. the main path: apps/kitti_lidar_odometry.py, in process, on
     config/kitti.yaml with --chunk 20 over a synthetic 240-frame KITTI
     sequence of 131072-point scans;
  3. loop closure: a ring circuit through Estimator.process_chunk with
     the loop worker on;
  4. KD-tree mode: apps/lidar_odometry.py, in process, on
     config/mid360.yaml over a synthetic corridor of PLY frames;
  5. one profiler trace of phase 2's steady chunk loop: the device's idle
     share and the device-to-host copies per chunk (reported, not
     checked).

`--four` runs only the sharded path: phase 2's sequence (60 frames,
per-frame) with the map sharded over four cards (--shards 4) against the
same run on one card, plus the partitioned Schur PGO solve on the
4-device mesh.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
import argparse
import contextlib
import glob
import importlib.util
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

KITTI_RAW_POINTS = 131072      # one HDL-64E scan (KITTI velodyne .bin)
KITTI_FRAMES = 240
KITTI_CHUNK = 20
TRACE_FRAMES = 100             # phase 5: 5 chunks, the last 3 steady
RING_FRAMES = 750
RING_CAPACITY = 16384
CORRIDOR_FRAMES = 60
FOUR_FRAMES = 60

CARD = ""                      # "name, power limit" from nvidia-smi


def _line(tag: str, text: str, seconds: float) -> None:
    print(f"[{tag}] {text} | {seconds:.1f} s | {CARD}", flush=True)


@contextlib.contextmanager
def _timed():
    t = {"start": time.perf_counter()}
    yield t
    t["s"] = time.perf_counter() - t["start"]


def _load_app(name: str):
    path = os.path.join(ROOT, "apps", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_config(src: str, dst: str, **keys) -> None:
    """Copy a shipped YAML config, changing only the given top-level keys."""
    with open(os.path.join(ROOT, "config", src)) as f:
        text = f.read()
    for k, v in keys.items():
        text, n = re.subn(rf"^{k}:.*$", f'{k}: "{v}"', text, flags=re.M)
        assert n == 1, (src, k)
    with open(dst, "w") as f:
        f.write(text)


def _parallel_map(fn, items):
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


# ---------------------------------------------------------------------------
# phase 1: parity helpers (also run at reduced sizes by tests/test_chip_smoke)
# ---------------------------------------------------------------------------

def kitti_scan(seed: int = 11, n_points: int = KITTI_RAW_POINTS):
    """One sensor-frame scan of the benchmark's synthetic city."""
    from lidar_odometry_tpu.io import synthetic
    world = synthetic.make_world(seed=seed, extent=120.0, n_buildings=28)
    pose = synthetic.straight_trajectory(1)[0]
    return synthetic.sample_scan(world, pose, n_points,
                                 np.random.default_rng(seed),
                                 max_range=80.0, noise=0.01)


def parity_voxel_filter(scan, *, stride=8, voxel=0.5, capacity=16384):
    """ops.voxel_filter vs a float64 per-voxel mean, both key paths.
    The voxel set and count must match exactly, centroids within 1e-4 m.
    Returns (n_voxels, worst centroid error in m)."""
    import jax.numpy as jnp
    from lidar_odometry_tpu.ops import voxel_filter as vf

    pts = scan[::stride]
    inv = np.float32(1.0) / np.float32(voxel)           # as on the device
    keys = np.floor(pts * inv).astype(np.int64)
    uniq, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                      return_counts=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inverse.reshape(-1), pts.astype(np.float64))
    means = sums / counts[:, None]
    assert len(uniq) <= capacity, (len(uniq), capacity)
    worst = 0.0
    for compact in (True, False):
        cen, mask, n = vf.voxel_filter(
            jnp.asarray(scan), jnp.int32(len(scan)), voxel_size=voxel,
            stride=stride, out_capacity=capacity, compact_keys=compact)
        cen, mask, n = np.asarray(cen), np.asarray(mask), int(n)
        assert n == len(uniq), (compact, n, len(uniq))
        assert mask[:n].all() and not mask[n:].any()
        # device order: the compact key is x-major, the (hi, lo) pair z-major
        order = (np.lexsort((uniq[:, 2], uniq[:, 1], uniq[:, 0])) if compact
                 else np.lexsort((uniq[:, 1], uniq[:, 0], uniq[:, 2])))
        err = float(np.abs(cen[:n] - means[order]).max())
        assert err <= 1e-4, (compact, err)
        worst = max(worst, err)
    return len(uniq), worst


def _oracle_module():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_voxel_map_oracle
    return test_voxel_map_oracle


def parity_map(*, c0=262144, c1=65536, scan_points=16384, updates=4,
               extent=40.0, probes=16384, seed=0):
    """update_map + lookup_surfels vs the dict oracle of the reference map
    semantics: identical L0 voxel set and surfel validity, normals (up to
    sign), L0 and surfel centroids within 1e-4. Returns (n_l0, surfels,
    worst error)."""
    import jax.numpy as jnp
    from lidar_odometry_tpu.ops import voxel_map as vm
    orc = _oracle_module()

    rng = np.random.default_rng(seed)
    oracle = orc.OracleMap()
    state = vm.empty_map(c0, c1)
    sensor = np.zeros(3, np.float32)
    max_dist = 1.5 * extent
    for _ in range(updates):
        pts = orc._make_points(rng, scan_points, lo=-extent, hi=extent)
        sensor = sensor + np.array([1.2, 0.4, 0.0], np.float32)
        oracle.update(pts, sensor, max_dist)
        buf = np.zeros((scan_points, 3), np.float32)
        buf[:len(pts)] = pts
        msk = np.arange(scan_points) < len(pts)
        state = vm.update_map(state, jnp.asarray(buf), jnp.asarray(msk),
                              jnp.asarray(sensor), max_dist,
                              voxel_size=orc.VOXEL,
                              planarity_threshold=orc.PLANARITY_THR,
                              hierarchy_factor=orc.HF)
    assert int(state.n_dropped) == 0, int(state.n_dropped)

    impl_l0 = orc._state_dicts(state)
    orc_l0 = {k: v[0] / v[1] for k, v in oracle.l0.items()}
    assert set(impl_l0) == set(orc_l0), (len(impl_l0), len(orc_l0))
    assert int(state.n_l0) == len(orc_l0)
    worst = max(float(np.abs(impl_l0[k] - c).max()) for k, c in orc_l0.items())

    cell = orc.VOXEL * orc.HF
    q = rng.uniform(-extent - 5, extent + 5, (probes, 3))
    frac = q / cell - np.floor(q / cell)
    q = q[np.all((frac > 1e-3) & (frac < 1 - 1e-3), axis=1)]  # off cell faces
    cents = [c["surfel"][1] for c in oracle.l1.values() if c["surfel"]]
    q = np.concatenate([q, np.asarray(cents).reshape(-1, 3)]).astype(np.float32)
    normals, centroids, valid = (np.asarray(a) for a in vm.lookup_surfels(
        state, jnp.asarray(q), voxel_size=orc.VOXEL, hierarchy_factor=orc.HF))
    n_surf = 0
    for i, p in enumerate(q):
        expect = oracle.query(p)
        assert valid[i] == (expect is not None), (p, valid[i])
        if expect is None:
            continue
        n_o, c_o, _ = expect
        worst = max(worst,
                    float(min(np.abs(normals[i] - n_o).max(),
                              np.abs(normals[i] + n_o).max())),
                    float(np.abs(centroids[i] - c_o).max()))
        n_surf += 1
    assert worst <= 1e-4, worst
    assert n_surf >= len(cents) > 0
    return len(orc_l0), n_surf, worst


def parity_gn(n=16384, seed=0):
    """ICP Gauss-Newton H, g on the device vs float64 numpy on the same
    Jacobians, weights and residuals. Relative (Frobenius) error <= 1e-5:
    TF32 operands would give ~1e-3. Returns (rel_H, rel_g)."""
    import jax
    import jax.numpy as jnp
    from lidar_odometry_tpu.ops import icp

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60.0, 60.0, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    yaw = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T[:3, 3] = [12.0, -3.0, 0.5]
    q = (pts @ T[:3, :3].T + T[:3, 3]
         - nrm * rng.normal(0, 0.05, (n, 1))).astype(np.float32)
    valid = rng.random(n) < 0.9
    resid = np.abs(rng.normal(0, 3.0, n)).astype(np.float32)
    cfg = icp.ICPConfig()

    @jax.jit
    def system(*args):
        J, w, r = icp._gn_terms(*args, cfg)
        return (J, w, r) + icp._gn_system(J, w, r)

    J, w, r, H, g = (np.asarray(a) for a in system(
        jnp.asarray(T), jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(q),
        jnp.asarray(valid), jnp.asarray(resid), jnp.float32(1.0)))
    J64, w64, r64 = (a.astype(np.float64) for a in (J, w, r))
    H64 = J64.T @ (J64 * w64[:, None])
    g64 = J64.T @ (w64 * r64)
    rel_h = float(np.linalg.norm(H - H64) / np.linalg.norm(H64))
    rel_g = float(np.linalg.norm(g - g64) / np.linalg.norm(g64))
    assert rel_h <= 1e-5 and rel_g <= 1e-5, (rel_h, rel_g)
    return rel_h, rel_g


def _pack_parent_keys(c):
    """(..., 3) int64 coords -> uint64 (hi << 32 | lo), as utils/keys."""
    hi = (c[..., 2] + 2**31) & 0xFFFFFFFF
    lo = (((c[..., 0] + 32768) & 0xFFFF) << 16) | ((c[..., 1] + 32768) & 0xFFFF)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def parity_grid_knn(*, c0=262144, c1=65536, voxel=0.4, radius=2,
                    n_query=16384, seed=0):
    """KD-tree-mode candidates (voxel_map.grid_knn_neighbors) vs a numpy
    brute force over the 5x5x5 neighbourhood: every neighbour's parent
    hit and l0_data row must match exactly (the map's slots run up from
    c1-1, far above 2048, where a TF32 index contraction breaks), and
    the candidate validity and centroids must agree. Returns (rows
    checked, highest slot hit)."""
    import jax
    import jax.numpy as jnp
    from lidar_odometry_tpu.io import synthetic
    from lidar_odometry_tpu.ops import voxel_map as vm

    rng = np.random.default_rng(seed)
    world = synthetic.make_world(seed=seed + 5, extent=40.0, n_buildings=10)
    state = vm.empty_map(c0, c1)
    poses = synthetic.straight_trajectory(3, step=1.0)
    for pose in poses:
        s = synthetic.sample_scan(world, pose, n_query, rng, max_range=30.0,
                                  noise=0.01)
        w = (s @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
        state = vm.update_map(state, jnp.asarray(w), jnp.ones(len(w), bool),
                              jnp.asarray(pose[:3, 3]), 100.0,
                              voxel_size=voxel, planarity_threshold=0.1)
    s = synthetic.sample_scan(world, poses[1], n_query, rng, max_range=30.0,
                              noise=0.05)
    query = (s @ poses[1][:3, :3].T + poses[1][:3, 3]).astype(np.float32)

    rows = jax.jit(vm._grid_knn_rows, static_argnums=(3, 4))
    addr, hit = (np.asarray(a) for a in rows(state, jnp.asarray(query),
                                              voxel, 3, radius))
    cen, ok = (np.asarray(a) for a in vm.grid_knn_neighbors(
        state, jnp.asarray(query), voxel_size=voxel, radius=radius))

    meta = np.asarray(state.l1_meta)
    live = np.nonzero(meta[:, 0] != -1)[0]
    key = ((meta[live, 0].view(np.uint32).astype(np.uint64) << np.uint64(32))
           | meta[live, 1].view(np.uint32).astype(np.uint64))
    order = np.argsort(key)
    key, slot_of = key[order], live[order]
    inv = np.float32(1.0) / np.float32(voxel)
    qc = np.floor(query * inv).astype(np.int64)
    r = np.arange(-radius, radius + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    nb = qc[:, None, :] + offs[None]
    par = np.floor_divide(nb, 3)
    ch = nb - 3 * par
    pk = _pack_parent_keys(par)
    pos = np.clip(np.searchsorted(key, pk), 0, len(key) - 1)
    hit_ref = key[pos] == pk
    addr_ref = (slot_of[pos] * 27
                + (ch[..., 0] * 3 + ch[..., 1]) * 3 + ch[..., 2])
    assert np.array_equal(hit, hit_ref)
    assert np.array_equal(addr[hit_ref], addr_ref[hit_ref])
    top_slot = int(addr_ref[hit_ref].max()) // 27
    assert top_slot > 2048, top_slot

    l0 = np.asarray(state.l0_data).astype(np.float64)
    rows_ref = l0[np.where(hit_ref, addr_ref, 0)]
    ok_ref = hit_ref & (rows_ref[..., 0] > 0)
    cen_ref = rows_ref[..., 1:4] / np.maximum(rows_ref[..., :1], 1.0)
    assert np.array_equal(ok, ok_ref)
    err = float(np.abs(cen[ok_ref] - cen_ref[ok_ref]).max())
    assert err <= 1e-4, err
    return int(hit_ref.sum()), top_slot


def _se3(yaw, t):
    T = np.eye(4)
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T[:3, 3] = t
    return T


def parity_pgo(n=65, loops=((8, 56), (16, 48)), seed=0):
    """The device float64 Gauss-Newton PGO (distributed_pgo, the
    distributed backend's solver) vs the host float64 solver of
    models/pose_graph.py, from the same start on a drifting chain with
    loop factors. Poses within 1e-6. Returns the worst pose entry error."""
    from lidar_odometry_tpu.models.pose_graph import PoseGraphOptimizer
    from lidar_odometry_tpu.parallel import distributed_pgo as dpgo

    rng = np.random.default_rng(seed)
    gt = [_se3(2 * np.pi * i / n, [20 * np.cos(2 * np.pi * i / n),
                                   20 * np.sin(2 * np.pi * i / n), 0.0])
          for i in range(n)]
    pg = PoseGraphOptimizer("manual")
    pg.add_first_keyframe(0, gt[0])
    est = gt[0]
    for i in range(1, n):
        meas = np.linalg.inv(gt[i - 1]) @ gt[i]
        meas = meas @ _se3(rng.normal(0, 0.01), rng.normal(0, 0.05, 3))
        est = est @ meas
        pg.add_keyframe_with_odom(i - 1, i, est, meas, 1.0, 1.0)
    for a, b in loops[:-1]:
        assert pg.add_loop_and_optimize(a, b, np.linalg.inv(gt[a]) @ gt[b],
                                        1.0, 1.0)
    start = np.stack([pg._poses[k] for k in pg._keyframe_ids])
    a, b = loops[-1]
    assert pg.add_loop_and_optimize(a, b, np.linalg.inv(gt[a]) @ gt[b],
                                    1.0, 1.0)
    host = np.stack([pg._poses[k] for k in pg._keyframe_ids])
    priors = [(p.key, p.measured, p.sqrt_info) for p in pg._priors]
    betweens = [(f.key_from, f.key_to, f.measured, f.sqrt_info)
                for f in pg._betweens]
    dev, ok = dpgo.gn_optimize_device(start, priors, betweens, n_blocks=8,
                                      max_iters=10, tol=1e-6)
    assert ok
    err = float(np.abs(dev - host).max())
    assert err <= 1e-6, err
    return err


def parity_schur(mesh, n=64, seed=0):
    """The partitioned Schur solve with its interior eliminations sharded
    over `mesh` (axis 'data'), float64 on the devices, vs a dense float64
    solve of the same chain + loop system. Returns the relative error."""
    import jax
    from lidar_odometry_tpu.parallel import distributed_pgo as dpgo

    rng = np.random.default_rng(seed)
    off = rng.standard_normal((n - 1, 6, 6)) * 0.3
    diag = np.eye(6) * 8.0 + rng.standard_normal((n, 6, 6)) * 0.1
    diag = (diag + np.swapaxes(diag, 1, 2)) / 2
    b = rng.standard_normal((n, 6))
    loop_edges = [(n // 6, 5 * n // 6), (n // 3, 2 * n // 3)]
    loop_blocks = [(np.eye(6) * 2.0, -np.eye(6), np.eye(6) * 2.0)] * 2
    ref = dpgo.dense_solve(diag, off, b, loop_edges, loop_blocks)
    size = mesh.devices.size
    seps = dpgo.plan_partition(n, size, loop_edges)
    while len(seps) % size:
        seps = dpgo.plan_partition(n, len(seps) + 1, loop_edges)
    with jax.enable_x64():
        x = dpgo.schur_partitioned_solve(diag, off, b, seps, loop_edges,
                                         loop_blocks, mesh=mesh,
                                         mesh_axis="data")
    rel = float(np.linalg.norm(x - ref) / np.linalg.norm(ref))
    assert rel <= 1e-9, rel
    return rel


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------

def write_kitti_sequence(root, n_frames, raw_points=KITTI_RAW_POINTS,
                         seed=11):
    """KITTI layout under root: sequences/07/velodyne/*.bin and the
    camera-frame ground truth gt/07.txt. Returns the lidar-frame poses."""
    from lidar_odometry_tpu.eval import lidar_pose_to_cam
    from lidar_odometry_tpu.io import synthetic

    world = synthetic.make_world(seed=seed, extent=120.0, n_buildings=28)
    poses = synthetic.straight_trajectory(n_frames, step=0.25)
    vel = os.path.join(root, "sequences", "07", "velodyne")
    os.makedirs(vel)
    os.makedirs(os.path.join(root, "gt"))

    def one(i):
        scan = synthetic.sample_scan(world, poses[i], raw_points,
                                     np.random.default_rng([seed, i]),
                                     max_range=80.0, noise=0.01)
        data = np.zeros((len(scan), 4), np.float32)
        data[:, :3] = scan
        data.tofile(os.path.join(vel, f"{i:06d}.bin"))

    _parallel_map(one, range(n_frames))
    with open(os.path.join(root, "gt", "07.txt"), "w") as f:
        for pose in poses:
            cam = lidar_pose_to_cam(pose.astype(np.float64))
            f.write(" ".join(f"{cam[r, c]:.9f}" for r in range(3)
                             for c in range(4)) + "\n")
    return poses


def ring_circuit(n_frames=RING_FRAMES, capacity=RING_CAPACITY, seed=31):
    """bench.py's loop circuit: ray-cast 32-ring scans on a 2-lap track."""
    from lidar_odometry_tpu.io import synthetic
    world = synthetic.make_world(seed=seed, extent=90.0, n_buildings=26)
    gt = synthetic.circuit_trajectory(n_frames, length=50.0, radius=22.0,
                                      step=0.65)
    scans = np.full((n_frames, capacity, 3), np.nan, np.float32)

    def one(i):
        s = synthetic.sample_scan_rings(
            world, gt[i], np.random.default_rng([seed, i]), n_rings=32,
            azimuth_steps=512, max_range=70.0, noise=0.01)
        scans[i, :min(len(s), capacity)] = s[:capacity]

    _parallel_map(one, range(n_frames))
    return scans, gt


def write_corridor(root, n_frames=CORRIDOR_FRAMES, seed=33):
    """MID360-style indoor corridor (tools/bench_accuracy.py's world) as
    PLY frames under root/slam. Returns the lidar-frame poses."""
    from lidar_odometry_tpu.io import synthetic
    from lidar_odometry_tpu.io.ply import save_ply
    poses = synthetic.circuit_trajectory(n_frames, length=24.0, radius=7.0,
                                         step=0.12, height=1.2)
    centre = synthetic.circuit_trajectory(
        64, length=24.0, radius=7.0, step=(2 * 24.0 + 2 * np.pi * 7.0) / 64,
        height=1.2)
    world = synthetic.make_corridor_world(centre[:, :2, 3], width=5.0,
                                          height=3.0, extent=25.0)

    def one(i):
        s = synthetic.sample_scan_rings(
            world, poses[i], np.random.default_rng([seed, i]), n_rings=40,
            azimuth_steps=720, max_range=25.0, noise=0.008,
            elevation_range=(-7.0, 52.0))
        save_ply(os.path.join(root, "slam", f"scan_{i:05d}.ply"), s)

    _parallel_map(one, range(n_frames))
    return poses


def _kitti_poses_lidar(path):
    from lidar_odometry_tpu.eval import T_LIDAR_TO_CAM
    from lidar_odometry_tpu.io.kitti import load_kitti_gt
    cam = load_kitti_gt(path)
    c_inv = np.linalg.inv(T_LIDAR_TO_CAM)
    return c_inv[None] @ cam @ T_LIDAR_TO_CAM[None]


def _tum_poses(path):
    from scipy.spatial.transform import Rotation
    rows = np.loadtxt(path, ndmin=2)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :3] = Rotation.from_quat(rows[:, 4:8]).as_matrix()
    T[:, :3, 3] = rows[:, 1:4]
    return T


# ---------------------------------------------------------------------------
# phases 2-5
# ---------------------------------------------------------------------------

def run_kitti_app(data_root, out_name, args):
    """apps/kitti_lidar_odometry.py main() in process on config/kitti.yaml
    (only the three directory keys changed). Returns (frames, ATE m,
    steady FPS from the player's statistics file)."""
    from lidar_odometry_tpu.eval import ate_rmse
    out = os.path.join(data_root, out_name)
    cfg = os.path.join(data_root, f"{out_name}.yaml")
    _write_config("kitti.yaml", cfg, data_directory=data_root,
                  ground_truth_directory=os.path.join(data_root, "gt"),
                  output_directory=out)
    assert _load_app("kitti_lidar_odometry").main([cfg] + args) == 0
    traj = _kitti_poses_lidar(os.path.join(out, "07", "07_lo_tpu.txt"))
    gt = _kitti_poses_lidar(os.path.join(data_root, "gt", "07.txt"))
    with open(os.path.join(out, "07", "07_statistics.txt")) as f:
        m = re.search(r"Steady FPS \(post-warmup\): ([0-9.]+)", f.read())
    return len(traj), ate_rmse(traj, gt[:len(traj)]), float(m.group(1)) if m else 0.0


def trace_summary(trace_dir, span="process_chunk", skip=2,
                  device_prefix="/device:GPU"):
    """Device idle share and device-to-host copies per chunk over the
    steady calls of the host span `span` (its first `skip` calls are
    warm-up) in a jax.profiler trace. Busy time is the union of the
    event intervals on the device planes within the window from the
    first steady call's start to the last one's end. Returns a dict;
    asserts nothing about the values."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    data = ProfileData.from_file(path)
    calls, events = [], []
    for plane in data.planes:
        on_device = plane.name.startswith(device_prefix)
        for line in plane.lines:
            for e in line.events:
                end = e.start_ns + e.duration_ns
                if plane.name.startswith("/host") and e.name == span:
                    calls.append((e.start_ns, end))
                if on_device and e.duration_ns > 0:
                    events.append((e.start_ns, end, e.name,
                                   e.name == "MemcpyD2H"))
    calls.sort()
    assert len(calls) > skip, f"{len(calls)} '{span}' spans in the trace"
    t0, t1 = calls[skip][0], calls[-1][1]
    chunks = len(calls) - skip
    busy, cur_s, cur_e = 0.0, None, None
    names, d2h, n_ev = {}, 0, 0
    for s, e, name, to_host in sorted(events):
        if e <= t0 or s >= t1:
            continue
        s, e = max(s, t0), min(e, t1)
        n_ev += 1
        d2h += to_host
        names[name] = names.get(name, 0.0) + (e - s) / 1e6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    assert n_ev, "no device events inside the steady window"
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ms": (t1 - t0) / 1e6, "chunks": chunks,
            "idle_share": 1.0 - busy / (t1 - t0),
            "d2h_copies_per_chunk": d2h / chunks,
            "device_events_per_chunk": n_ev / chunks,
            "top_device_events_ms": {k: round(v, 3) for k, v in top}}


def phase_parity():
    import jax
    with _timed() as t:
        n, err = parity_voxel_filter(kitti_scan())
    _line("1a", f"voxel_filter 131072 pts stride 8: {n} voxels exact, "
          f"centroid err {err:.2e} m", t["s"])
    with _timed() as t:
        n_l0, n_surf, err = parity_map()
    _line("1b", f"update_map+lookup_surfels c0=262144 c1=65536 vs dict "
          f"oracle: {n_l0} voxels, {n_surf} surfel hits, max err {err:.2e}",
          t["s"])
    with _timed() as t:
        rel_h, rel_g = parity_gn()
    _line("1c", f"ICP normal equations N=16384 vs float64: rel err H "
          f"{rel_h:.2e} g {rel_g:.2e}", t["s"])
    with _timed() as t:
        n_rows, top = parity_grid_knn()
    _line("1d", f"grid_knn radius 2 N=16384 vs brute force: {n_rows} rows "
          f"exact, top slot {top}", t["s"])
    with _timed() as t:
        err = parity_pgo()
        from lidar_odometry_tpu.parallel.mesh import make_mesh
        rel = parity_schur(make_mesh(1, ("data",)))
    _line("1e", f"device float64 PGO vs host solver: max pose err {err:.2e}; "
          f"Schur solve on {jax.devices()[0].device_kind} mesh rel err "
          f"{rel:.2e}", t["s"])


def phase_main_path(data_root):
    with _timed() as t:
        write_kitti_sequence(data_root, KITTI_FRAMES)
    gen = t["s"]
    with _timed() as t:
        frames, ate, fps = run_kitti_app(data_root, "out_chunk",
                                         ["--chunk", str(KITTI_CHUNK)])
    assert frames == KITTI_FRAMES, frames
    assert ate <= 0.05, ate
    _line("2", f"kitti player --chunk {KITTI_CHUNK}: {frames} frames of "
          f"{KITTI_RAW_POINTS} pts, ATE {ate:.4f} m, steady {fps:.1f} "
          f"scans/s (data written in {gen:.1f} s)", t["s"])


def phase_loops():
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.eval import ate_rmse
    from lidar_odometry_tpu.models.estimator import Estimator
    with _timed() as t:
        scans, gt = ring_circuit()
    gen = t["s"]
    with _timed() as t:
        cfg = SystemConfig(
            scan_capacity=8192, map_l0_capacity=262144,
            map_l1_capacity=65536, keyframe_capacity=1024, point_stride=1,
            voxel_size=0.5, map_voxel_size=0.5, max_range=100.0,
            enable_loop_detection=True, min_keyframe_gap=40,
            max_search_distance=6.0, similarity_threshold=0.35,
            enable_console_statistics=False)
        est = Estimator(cfg)
        est.warm_loop_programs()
        for c in range(0, len(scans), 25):
            est.process_chunk(scans[c:c + 25])
        est.finalize_loops()
        loops = est.loop_constraint_count
        ate = ate_rmse(est.trajectory(), gt)
        est.shutdown()
    assert loops >= 1, loops
    assert ate <= 0.01, ate
    _line("3", f"ring circuit {len(scans)} frames, loops on: {loops} loop "
          f"constraints, ATE {ate:.4f} m (data made in {gen:.1f} s)", t["s"])


def phase_kdtree(data_root):
    from lidar_odometry_tpu.eval import ate_rmse
    with _timed() as t:
        gt = write_corridor(data_root)
    gen = t["s"]
    with _timed() as t:
        out = os.path.join(data_root, "out_ply")
        cfg = os.path.join(data_root, "mid360.yaml")
        _write_config("mid360.yaml", cfg, data_directory=data_root,
                      output_directory=out)
        app = _load_app("lidar_odometry")
        assert app.main([cfg, "--format", "tum", "--chunk", "20"]) == 0
        traj = _tum_poses(os.path.join(out, "slam", "slam_lo_tpu.txt"))
    assert len(traj) == len(gt) and np.isfinite(traj).all()
    ate = ate_rmse(traj, gt)
    assert ate <= 0.1, ate
    _line("4", f"PLY player KD-tree mode (mid360.yaml): {len(traj)} corridor "
          f"frames, ATE {ate:.4f} m (data written in {gen:.1f} s)", t["s"])


def phase_profile(data_root):
    import jax
    trace_dir = os.path.join(data_root, "trace")
    with _timed() as t:
        with jax.profiler.trace(trace_dir):
            run_kitti_app(data_root, "out_trace",
                          ["--chunk", str(KITTI_CHUNK),
                           "--end", str(TRACE_FRAMES)])
        s = trace_summary(trace_dir)
    _line("5", f"trace of {s['chunks']} steady chunks ({s['window_ms']:.1f} "
          f"ms): device idle share {s['idle_share']:.3f}, "
          f"{s['d2h_copies_per_chunk']:.1f} device-to-host copies per chunk, "
          f"{s['device_events_per_chunk']:.0f} device events per chunk",
          t["s"])
    print("[5] top device events (ms in window): "
          + json.dumps(s["top_device_events_ms"]), flush=True)


def phase_four(data_root):
    """--shards 4 vs one card on phase 2's sequence, per frame."""
    import jax
    from lidar_odometry_tpu.config import load_config
    from lidar_odometry_tpu.io.kitti import KittiPlayer
    from lidar_odometry_tpu.parallel.mesh import make_mesh

    with _timed() as t:
        write_kitti_sequence(data_root, FOUR_FRAMES)
    gen = t["s"]
    cfg_path = os.path.join(data_root, "kitti.yaml")
    _write_config("kitti.yaml", cfg_path, data_directory=data_root,
                  ground_truth_directory=os.path.join(data_root, "gt"),
                  output_directory="")
    cfg = load_config(cfg_path)
    runs = {}
    for shards in (4, 0):
        with _timed() as t:
            player = KittiPlayer(cfg)
            res = player.run(sync_loop=True, shards=shards, chunk_frames=0)
            assert res.frames_processed == FOUR_FRAMES
            runs[shards] = (player, player.estimator.trajectory())
        _line("4x", f"--shards {shards}: {FOUR_FRAMES} frames per frame, "
              f"ATE {res.error_stats.ate_rmse:.4f} m (data written in "
              f"{gen:.1f} s)", t["s"])
    diff = float(np.linalg.norm(runs[4][1][:, :3, 3] - runs[0][1][:, :3, 3],
                                axis=1).max())
    assert diff <= 1e-3, diff
    state = runs[4][0].estimator.map_state
    devices = set(jax.devices()[:4])
    for name in ("l0_data", "l1_index", "l1_meta", "l1_surfel"):
        leaf = getattr(state, name)
        shards = leaf.addressable_shards
        assert {s.device for s in shards} == devices, name
        assert all(s.data.shape[0] * 4 == leaf.shape[0] for s in shards), name
    mem = {d.id: (d.memory_stats() or {}).get("bytes_in_use")
           for d in jax.devices()}
    with _timed() as t:
        rel = parity_schur(make_mesh(4, ("data",)))
    _line("4x", f"trajectories agree within {diff:.2e} m; map tables sharded "
          f"over devices {sorted(d.id for d in devices)}; bytes_in_use per "
          f"device {mem}; Schur PGO on the 4-device mesh rel err {rel:.2e}",
          t["s"])


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded-map comparison")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "lidar_odometry_tpu")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    from lidar_odometry_tpu.utils import gpu

    devices = gpu.require_gpu()
    need = 4 if args.four else 1
    if len(devices) < need:
        sys.exit(f"needs {need} GPUs, found {len(devices)}")
    CARD = gpu.card_name_and_power_limit().splitlines()[0]
    print(f"device_kind: {devices[0].device_kind}")
    print(f"device_count: {len(devices)}")
    print(f"nvidia-smi: {CARD}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            phase_four(os.path.join(tmp, "four"))
        else:
            phase_parity()
            phase_main_path(os.path.join(tmp, "kitti"))
            phase_loops()
            phase_kdtree(os.path.join(tmp, "corridor"))
            phase_profile(os.path.join(tmp, "kitti"))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
