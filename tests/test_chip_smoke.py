"""CPU coverage of the GPU smoke script (chip_smoke.py) and of the GPU
bring-up plumbing: the script refuses the CPU, its parity helpers hold at
reduced sizes against the same plain references, and its trace reduction
reads a recorded trace."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from lidar_odometry_tpu.parallel.mesh import make_mesh  # noqa: E402


def _run_smoke(cwd, script, cache_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache_dir))
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu(tmp_path):
    out = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), "chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("stride,capacity", [(8, 16384), (1, 131072)])
def test_voxel_filter_parity_full_scan(stride, capacity):
    """A 131072-point scan against a float64 per-voxel mean (both key
    paths): exact voxel set and count, centroids within 1e-4 m."""
    n, err = cs.parity_voxel_filter(cs.kitti_scan(), stride=stride,
                                    capacity=capacity)
    assert n > 1000 and err <= 1e-5


def test_map_parity_small():
    n_l0, n_surf, err = cs.parity_map(c0=16384, c1=4096, scan_points=1024,
                                      updates=3, extent=12.0, probes=512)
    assert n_l0 > 500 and n_surf > 20


def test_gn_parity_small():
    rel_h, rel_g = cs.parity_gn(n=2048)
    assert rel_h < 1e-6


def test_grid_knn_parity_small():
    rows, top_slot = cs.parity_grid_knn(c0=32768, c1=8192, n_query=2048)
    assert rows > 10000 and top_slot > 2048


def test_pgo_parity_small():
    assert cs.parity_pgo(n=33, loops=((8, 24),)) <= 1e-6


@pytest.mark.parametrize("n_devices", [1, 4])
def test_schur_parity_on_mesh(n_devices):
    assert cs.parity_schur(make_mesh(n_devices, ("data",)), n=32) <= 1e-9


def test_trace_summary_reads_recorded_trace(tmp_path):
    """The phase-5 reduction on a CPU trace (XLA:CPU puts its op events
    on the host plane): four "process_chunk" spans, the first skipped."""
    @jax.jit
    def chunk(x):
        return jnp.sin(x) @ x

    x = jnp.ones((128, 128))
    chunk(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(4):
            with jax.profiler.TraceAnnotation("process_chunk"):
                chunk(x).block_until_ready()
    s = cs.trace_summary(str(tmp_path), skip=1, device_prefix="/host:CPU")
    assert s["chunks"] == 3
    assert 0.0 <= s["idle_share"] <= 1.0
    assert s["window_ms"] > 0 and s["device_events_per_chunk"] > 0
    assert s["d2h_copies_per_chunk"] == 0


def test_write_config_changes_only_directories(tmp_path):
    from lidar_odometry_tpu.config import load_config
    dst = str(tmp_path / "k.yaml")
    cs._write_config("kitti.yaml", dst, data_directory="/d",
                     ground_truth_directory="/g", output_directory="/o")
    got = load_config(dst)
    ref = load_config(os.path.join(ROOT, "config", "kitti.yaml"))
    assert (got.data_directory, got.ground_truth_directory,
            got.output_directory) == ("/d", "/g", "/o")
    assert got.replace(data_directory=ref.data_directory,
                       ground_truth_directory=ref.ground_truth_directory,
                       output_directory=ref.output_directory) == ref
    assert (got.scan_capacity, got.map_l0_capacity, got.map_l1_capacity,
            got.keyframe_capacity) == (16384, 262144, 65536, 4096)
