"""Test configuration: run everything on an 8-device virtual CPU mesh.

SURVEY.md §4 implication (d): multi-device paths are validated with
``xla_force_host_platform_device_count`` so no GPU is needed in CI.
``jax.config.update`` pins the CPU backend even where JAX_PLATFORMS says
otherwise; XLA_FLAGS is read lazily at first backend init, so setting it here
works as long as no jax computation ran before pytest startup. The compiled
GPU kernels are checked by chip_smoke.py on the card, not here.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")


# Heavy-first scheduling: the slowest modules (flagship compiles, sharded
# parity, record replays) start FIRST so xdist workers fill the tail with
# cheap tests instead of serializing a 6-minute test at the end of the run
# (33:48 -> target <20 min; VERDICT r4 #10). Within-module order is preserved
# (stable sort), so xdist_group bucketing is unaffected.
_HEAVY_FIRST = [
    "test_sharded_parity.py",
    "test_sharc_full.py",
    "test_glass_sharc.py",
    "test_records_replay.py",
    "test_golden.py",
    "test_gatherpass.py",
    "test_confidence.py",
    "test_shadow_translucency.py",
    "test_grad.py",
    "test_distributed.py",
    "test_neural_rr.py",
]


def pytest_collection_modifyitems(config, items):
    rank = {m: i for i, m in enumerate(_HEAVY_FIRST)}

    def key(item):
        return rank.get(item.fspath.basename, len(_HEAVY_FIRST))

    items.sort(key=key)
