"""Test config.

Two requirements (mirrors the reference's single-node test strategy,
SURVEY.md §4, with a fake mesh instead of required hardware):
  * keep whatever real accelerator the environment provides as the default
    backend (Pallas kernels then run on real TPU when available);
  * additionally expose an 8-virtual-device CPU backend so sharding /
    collective tests can build a multi-device mesh anywhere
    (``jax.devices("cpu")``).
"""

import os

platforms = os.environ.get("JAX_PLATFORMS", "")
if platforms and "cpu" not in platforms.split(","):
    os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
else:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# Tests must be deterministic and fast: never trigger the one-time on-device
# block sweep from inside the suite (each unseen shape bucket would add
# minutes of relay compiles); lookups still resolve factory/cached entries.
os.environ.setdefault("GR_TPU_ATTN_AUTOTUNE", "off")

import jax  # noqa: E402

# Differential tests compare against exact numpy references; the platform's
# default matmul precision is reduced (bf16-like), so force exact f32.
jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's kernels); skips without one",
    )
