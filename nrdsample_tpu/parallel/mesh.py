"""Device mesh construction + pixel sharding for the render pipeline.

Design (SURVEY.md §2.4): the image-space analogue of data parallelism — every
per-pixel pass shards its flat pixel dimension over the mesh axis "px"; the
scene is replicated; scene-parameter gradients are all-reduced across
devices. The 1-D mesh suits GPUs joined all to all by NVLink (XLA issues the
collectives through NCCL). Multi-host: the same mesh spans hosts via
jax.distributed.initialize.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PIXEL_AXIS = "px"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (PIXEL_AXIS,))


def pixel_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PIXEL_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_pixels(mesh: Mesh, n_pixels: int):
    """Flat pixel indices laid out and sharded across the mesh: (N,) int32."""
    idx = jnp.arange(n_pixels, dtype=jnp.int32)
    return jax.device_put(idx, pixel_sharding(mesh))


def pixel_specs_for(tree, n_pixels: int):
    """Per-leaf PartitionSpecs: leaves with a leading pixel dim shard over `px`,
    scalars/others replicate. Used for the History pytree (mixed state)."""
    return jax.tree.map(
        lambda leaf: P(PIXEL_AXIS)
        if (getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == n_pixels)
        else P(),
        tree,
    )


def sharded_render_fn(ctx, cfg, mesh: Mesh):
    """Two-phase sharded frame (SURVEY.md §2.4): rays shard perfectly, stencils
    see exact halos — so the sharded frame equals the single-chip frame.

      phase 1  trace_frame inside shard_map: each device traces its pixel rows
               (scene/camera/SHARC/L1 replicated; the packet traversal
               kernel runs per device on its local rays);
      phase 2  image_frame OUTSIDE shard_map on the global row-sharded planes:
               GSPMD partitions the denoiser stencils and inserts the exact
               halo collectives (history gathers included).

    Returns fn(scene, cam, settings, history, pixel_idx) -> (outputs, history')
    — NOT jitted; wrap in jax.jit at the call site. pixel_idx must be the full
    jnp.arange(n_pixels) laid out with pixel_sharding(mesh) (see shard_pixels).
    """
    from nrdsample_tpu.pipeline import frame as frame_mod

    def trace_local(scene, cam, settings, sharc, l1, frame_index, pixel_idx):
        h = frame_mod.History(frame_index=frame_index, sharc=sharc, l1=l1)
        # probe_axis shards the SHARC probe grid with the pixels (each device
        # traces 1/n of the probes, gathered back — bit-identical, see
        # sharc_update.sharc_update_pass)
        return frame_mod.trace_frame(
            ctx, scene, cam, cfg, settings, h, pixel_idx=pixel_idx,
            probe_axis=PIXEL_AXIS,
        )

    traced = jax.shard_map(
        trace_local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(PIXEL_AXIS)),
        out_specs=(P(PIXEL_AXIS), P()),   # gb per-pixel; aux replicated
        check_vma=False,
    )

    def frame_fn(scene, cam, settings, history, pixel_idx):
        gb, aux = traced(
            scene, cam, settings, history.sharc, history.l1,
            history.frame_index, pixel_idx,
        )
        return frame_mod.image_frame(cfg, settings, cam, history, gb, aux)

    return frame_fn
