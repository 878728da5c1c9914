"""Worker for test_distributed.py: one process of a 2-process jax.distributed
bring-up over localhost (the multi-host path, SURVEY.md §2.4(c)/§5.8).

Each process owns 2 virtual CPU devices -> a (2 hosts, 2 chips) global mesh.
Exercises: distributed.init (gRPC coordinator), global_mesh, broadcast_scene
(host-0 pytree to all), and a psum-style global reduction through pjit over
the host axis (the scene-gradient all-reduce role).

Usage: python distributed_worker.py <coordinator> <num_procs> <process_id>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# config.update before first backend use forces CPU + 2 virtual devices per
# process, whatever JAX_PLATFORMS says
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

import jax.numpy as jnp
import numpy as np

from nrdsample_tpu.parallel import distributed


def main():
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    active = distributed.init(coord, n_proc, pid)
    assert active, "distributed.init must report active for explicit args"
    assert jax.process_count() == n_proc, jax.process_count()
    assert len(jax.devices()) == 2 * n_proc, len(jax.devices())

    mesh = distributed.global_mesh()
    assert mesh.devices.shape == (n_proc, 2), mesh.devices.shape

    # scene broadcast: host 0's pytree must reach every process
    local = {"albedo": np.full((4, 3), float(pid), np.float32),
             "ior": np.float32(1.5 + pid)}
    got = distributed.broadcast_scene(local)
    np.testing.assert_allclose(np.asarray(got["albedo"]), 0.0)
    assert float(got["ior"]) == 1.5

    # global reduction across BOTH axes ('host' + 'chip'): the
    # scene-gradient all-reduce shape of pipeline/train.py
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = 2 * n_proc
    global_shape = (n_dev * 8,)
    sharding = NamedSharding(mesh, P(("host", "chip")))
    global_data = np.arange(global_shape[0], dtype=np.float32)
    garr = jax.make_array_from_callback(
        global_shape, sharding, lambda idx: global_data[idx]
    )
    total = jax.jit(lambda x: jnp.sum(x), out_shardings=None)(garr)
    expect = float(np.arange(global_shape[0], dtype=np.float32).sum())
    assert float(total) == expect, (float(total), expect)
    print(f"worker {pid}: OK", flush=True)


if __name__ == "__main__":
    main()
