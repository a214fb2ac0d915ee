"""lidar_odometry_tpu — a real-time LiDAR odometry + SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++ system (`SiarheiHerasiuta/lidar_odometry`): Morton/voxel downsampling,
a 2-level voxel surfel map, point-to-plane ICP with Gauss-Newton on SE(3)
and a PKO adaptive M-estimator, LiDAR-Iris loop closure, and pose-graph
optimization — expressed as fixed-shape array programs that XLA compiles
for the accelerator (sorted device tables + batched gathers instead of
pointer-chasing hash maps; masked vectorized ops instead of per-point
branching; async dispatch instead of threads). The package is named for
the accelerator it was first written for; it runs on NVIDIA GPUs.

Layout (mirrors the reference layer map, SURVEY.md §1):
  utils/    L0: Lie groups, voxel keys, 3x3 eigendecomposition, logging, IO
  ops/      L1/L2: voxel filter, voxel surfel map, ICP, PKO, Iris descriptor
  models/   L3: frames, estimator (pipeline orchestrator), loop closure, PGO
  parallel/ device-mesh sharding: sharded map lookup, distributed Schur PGO
  io/       L5: dataset players (KITTI .bin, PLY), trajectory writers, eval
  runtime/  native C++ data loader (ctypes) with numpy fallback
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Full float32 operand precision for every matmul. XLA:GPU may otherwise
# run float32 dots on TF32 tensor cores (10-bit mantissa): point
# transforms lose ~0.1 m at 100 m range, the Gauss-Newton normal
# equations (ops/icp.py) lose ~1e-3 relative precision, and any index
# carried through a contraction stops being exact above 2048. The
# matmuls here are tiny (3- and 6-wide), so full precision costs nothing
# measurable.
_jax.config.update("jax_default_matmul_precision", "float32")

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compilation_cache_dir(environ=_os.environ) -> str:
    """Persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
    when set, else a fixed `.jax_cache` directory in the checkout (a
    fixed path, so a second process finds what the first compiled)."""
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO_ROOT, ".jax_cache"))


_jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
