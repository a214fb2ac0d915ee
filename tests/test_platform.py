"""Package-level settings the GPU build depends on: pytree dataclasses
without flax, the compilation cache placement, full float32 matmul
precision, and meshes that refuse to shrink."""
import os
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest

import lidar_odometry_tpu
from lidar_odometry_tpu.ops import icp, pko
from lidar_odometry_tpu.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _consts(**kw):
    args = dict(min_scale=0.1, max_scale=10.0, num_segments=20,
                truncated_threshold=10.0, kernel_type="huber",
                gmm_components=3, gmm_sample_size=100)
    args.update(kw)
    return pko.make_pko_constants(**args)


def test_icp_config_is_a_leafless_hashable_pytree():
    cfg = icp.ICPConfig(max_iterations=3, loss_type="cauchy")
    leaves, treedef = jax.tree_util.tree_flatten(cfg)
    assert leaves == []
    assert jax.tree_util.tree_unflatten(treedef, leaves) == cfg
    assert hash(cfg) == hash(icp.ICPConfig(max_iterations=3,
                                           loss_type="cauchy"))
    with pytest.raises(AttributeError):
        cfg.max_iterations = 5                      # frozen


def test_pko_constants_roundtrip_keeps_static_fields():
    c = _consts()
    leaves, treedef = jax.tree_util.tree_flatten(c)
    assert len(leaves) == 4                         # alphas, Z, r_grid, Q
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert (back.kernel_type, back.gmm_components, back.gmm_sample_size) \
        == ("huber", 3, 100)
    np.testing.assert_array_equal(back.Q, c.Q)


def test_static_field_changes_retrace():
    traces = []

    @partial(jax.jit, static_argnames=("cfg",))
    def f(x, consts, cfg):
        traces.append((cfg.max_iterations, consts.gmm_sample_size))
        return x * cfg.max_iterations + consts.alphas[0]

    c = _consts()
    f(1.0, c, cfg=icp.ICPConfig(max_iterations=2))
    f(2.0, c, cfg=icp.ICPConfig(max_iterations=2))     # cache hit
    assert len(traces) == 1
    f(1.0, c, cfg=icp.ICPConfig(max_iterations=3))     # static ICP field
    f(1.0, _consts(gmm_sample_size=50),                # PKO metadata
      cfg=icp.ICPConfig(max_iterations=3))
    assert traces[1:] == [(3, 100), (3, 50)]


def test_main_path_imports_no_flax(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import chip_smoke, bench;"
            "import lidar_odometry_tpu.io.kitti, lidar_odometry_tpu.io.ply;"
            "import lidar_odometry_tpu.models.fast_pipeline;"
            "import lidar_odometry_tpu.parallel.pipeline;"
            "import lidar_odometry_tpu.models.map_backend;"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'flax'];"
            "assert not bad, bad")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_compilation_cache_dir_follows_env_else_checkout():
    assert lidar_odometry_tpu.compilation_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/srv/cache"}) == "/srv/cache"
    assert lidar_odometry_tpu.compilation_cache_dir({}) == os.path.join(
        ROOT, ".jax_cache")


def test_test_suite_writes_no_compilation_cache():
    assert jax.config.jax_compilation_cache_dir == \
        lidar_odometry_tpu.compilation_cache_dir()
    assert not jax.config.jax_enable_compilation_cache


def test_matmul_precision_is_full_float32():
    assert jax.config.jax_default_matmul_precision == "float32"


def test_make_mesh_refuses_missing_devices():
    assert make_mesh(8, ("map",)).devices.size == 8
    with pytest.raises(ValueError, match="16-device mesh"):
        make_mesh(16, ("map",))


def test_kitti_player_refuses_missing_shards(tmp_path):
    from lidar_odometry_tpu.config import SystemConfig
    from lidar_odometry_tpu.io.kitti import KittiPlayer
    np.zeros((100, 4), np.float32).tofile(str(tmp_path / "000000.bin"))
    player = KittiPlayer(SystemConfig(data_directory=str(tmp_path),
                                      enable_loop_detection=False))
    with pytest.raises(ValueError, match="16-device mesh"):
        player.run(shards=16)


def test_graft_dryrun_refuses_missing_devices():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    with pytest.raises(ValueError, match="16-device mesh"):
        ge.dryrun_multichip(16)
