"""Multi-process orchestration — jax.distributed + mesh construction.

Reference context (SURVEY.md §5.8): the reference has NO distributed backend.
Here jax.distributed handles process bring-up and scene broadcast over the
network; the per-step collectives (psum/ppermute inside the sharded frame and
train step, parallel/mesh.py + parallel/halo.py) run over NVLink through
NCCL between the GPUs of a host, and over the network between hosts.

Usage with one process per host (nothing is auto-detected: pass the
coordinator, process count and id, or set COORDINATOR_ADDRESS):

    from nrdsample_tpu.parallel import distributed
    distributed.init("host0:1234", 2, rank)   # no-op without a coordinator
    mesh = distributed.global_mesh()          # (hosts, devices_per_host) Mesh
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-process; returns whether
    distributed mode is active. Single-process (1 host, CI, CPU tests) is a
    no-op — all entry points work unchanged.

    The coordinator comes from the argument or COORDINATOR_ADDRESS; without
    either this returns False.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(axis_names: tuple = ("host", "chip")) -> Mesh:
    """(n_hosts, devices_per_host) device mesh: pixel/ray sharding rides the
    'chip' axis (NVLink within a host); the 'host' axis crosses the network
    and should only carry all-reduces that are already small (scene-parameter
    gradients)."""
    devs = np.array(jax.devices())
    n_proc = jax.process_count()
    per = len(devs) // max(n_proc, 1)
    return Mesh(devs.reshape(n_proc, per), axis_names)


def broadcast_scene(scene):
    """Host-0 scene -> every process (the network scene-broadcast role of the
    streamer, SURVEY.md §5.8). With jax.distributed active,
    `jax.experimental.multihost_utils.broadcast_one_to_all` ships the pytree;
    single-process returns the scene unchanged."""
    if jax.process_count() <= 1:
        return scene
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(scene)
