"""Test configuration: force the CPU backend with a virtual 8-device mesh
so sharding tests run without accelerator hardware (SURVEY.md §4 test
strategy).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NO persistent compilation cache for the CPU test suite. XLA:CPU's
# executable (de)serialization is unreliable on some hosts: an entry
# written on a host with different CPU vector extensions segfaults on
# load (JAX's cache key omits host features), and serialization itself
# can SIGABRT for some programs. In-process jit caching still
# deduplicates within a run.
jax.config.update("jax_enable_compilation_cache", False)


def pytest_collection_modifyitems(config, items):
    """Run the heaviest-compile modules FIRST. XLA:CPU segfaults inside
    backend_compile (LLVM) when the very large bulk-tier voxel-map
    programs compile late in a long-lived process that has already built
    ~100 other executables on some hosts — the same tests pass in a
    fresh process, and nothing in JAX-land reaches the crash (it is
    below backend_compile_and_load). Compiling the big programs while
    the process is fresh sidesteps it without changing any test."""
    front = ("test_voxel_map.py", "test_voxel_map_oracle.py",
             "test_fast_pipeline.py")

    def key(item):
        name = item.fspath.basename
        return (front.index(name) if name in front else len(front), 0)

    items.sort(key=key)
