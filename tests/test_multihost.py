"""Multi-host process-group smoke test: two REAL processes join via
jax.distributed.initialize over localhost (the DCN story of SURVEY.md
§2.5 as code), build a global mesh, and psum across processes.

Runs the workers as subprocesses so the test itself stays in the normal
single-process CPU session.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
sys.path.insert(0, os.environ["REPO_ROOT"])
from lidar_odometry_tpu.parallel import mesh as mesh_mod

pid = mesh_mod.initialize_multihost(
    coordinator_address=os.environ["COORD"],
    num_processes=2, process_id=int(sys.argv[1]))
assert jax.process_count() == 2
assert len(jax.devices()) == 4  # 2 local x 2 processes

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = mesh_mod.make_mesh(4, ("map",))
arr = jax.make_array_from_callback(
    (4, 8), NamedSharding(mesh, P("map")),
    lambda idx: jnp.full((1, 8), float(idx[0].start)))
total = jax.jit(lambda x: jnp.sum(x),
                out_shardings=NamedSharding(mesh, P()))(arr)
expect = sum(i * 8 for i in range(4))
assert float(total) == expect, (float(total), expect)

# ---- the FULL sharded op set across the process boundary (round-2
# VERDICT item 9): map update -> surfel lookup -> distributed robust
# ICP -> rehash -> distributed Schur PGO, all on the 2-process mesh ----
import numpy as np
from lidar_odometry_tpu.ops import icp as icp_ops
from lidar_odometry_tpu.parallel import sharded_map as sm
from lidar_odometry_tpu.parallel import distributed_pgo as dpgo

rep = NamedSharding(mesh, P())
rng = np.random.default_rng(0)
# a tilted plane patch + a wall: enough structure for surfels + ICP
g = np.stack(np.meshgrid(np.linspace(-8, 8, 40),
                         np.linspace(-8, 8, 40)), -1).reshape(-1, 2)
ground = np.concatenate([g, 0.02 * g[:, :1]], 1)
wall_y = np.concatenate([g[:, :1], np.full((len(g), 1), 8.0),
                         4 + g[:, 1:] * 0.4], 1)
wall_x = np.concatenate([np.full((len(g), 1), 8.0), g[:, :1],
                         4 + g[:, 1:] * 0.4], 1)
pts = np.concatenate([ground, wall_y, wall_x]).astype(np.float32)
pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
mask = np.ones(len(pts), bool)

state = sm.sharded_empty_map(2048 * 27, 2048, mesh)
state = sm.sharded_update_map(
    state, jnp.asarray(pts), jnp.asarray(mask), jnp.zeros(3), 120.0,
    mesh, voxel_size=0.5, planarity_threshold=0.6)
n_l0 = int(jax.jit(jnp.sum, out_shardings=rep)(state.n_l0))
assert n_l0 > 500, n_l0

nrm, cen, valid = sm.sharded_lookup_surfels(
    state, jnp.asarray(pts[::13]), mesh, voxel_size=0.5)
n_valid = int(jnp.sum(valid))
assert n_valid > 20, n_valid

cfg = icp_ops.ICPConfig(max_iterations=4, voxel_size=0.5,
                        use_adaptive_m_estimator=False,
                        min_correspondence_points=30)
T0 = np.eye(4, dtype=np.float32)
T0[:3, 3] = [0.08, -0.05, 0.04]
T_opt, ok, n_corr = sm.sharded_icp_optimize(
    state, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(T0), mesh, cfg)
assert bool(ok), int(n_corr)
t_err = float(jnp.linalg.norm(T_opt[:3, 3]))
assert t_err < 0.05, t_err  # pulled back to identity

C = np.eye(4, dtype=np.float32)
C[:3, 3] = [0.5, 0.0, 0.0]
state2 = sm.sharded_transform_and_rehash(
    state, jnp.asarray(C), mesh, voxel_size=0.5, planarity_threshold=0.6)
n_l0_2 = int(jax.jit(jnp.sum, out_shardings=rep)(state2.n_l0))
assert abs(n_l0_2 - n_l0) < 0.1 * n_l0, (n_l0, n_l0_2)

n_kf = 16
diag = np.tile(np.eye(6, dtype=np.float32) * 4.0, (n_kf, 1, 1))
off = np.tile(-np.eye(6, dtype=np.float32), (n_kf - 1, 1, 1))
b = rng.standard_normal((n_kf, 6)).astype(np.float32)
seps = dpgo.plan_partition(n_kf, 4, [])
x = dpgo.schur_partitioned_solve(diag, off, b, seps, mesh=mesh,
                                 mesh_axis="map")
assert np.all(np.isfinite(x))
print(f"OK process {pid}")
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_group_psum(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["COORD"] = f"127.0.0.1:{port}"
    env["REPO_ROOT"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-2000:]}"
        assert f"OK process {i}" in out
