"""Test configuration: force an 8-device virtual CPU mesh.

Mirrors the reference's strategy-parameterized tests
(tf_agents/train/learner_test.py:46-69) which fabricate multi-device rigs on
one host; here we use XLA's host-platform device-count override so sharding
paths (pjit / shard_map over a Mesh) execute without TPU hardware.
"""
import os

# Force CPU (the re-exec in the root conftest.py normally handles this
# before we get here; keep as a belt-and-braces default).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
  os.environ["XLA_FLAGS"] = (
      flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
# Persistent compile cache: CPU compiles here are slow and repeated across
# test processes.
jax.config.update("jax_compilation_cache_dir", "/root/.jax_cache_cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "slow: a long learning run, left out of the tier-1 run "
      "(-m 'not slow')")
