"""Multi-chip parallelism: device meshes, pixel/ray sharding, gradient psum,
halo exchange for denoiser stencils — the subsystems the single-GPU reference
never needed (SURVEY.md §2.4, §5.7, §5.8), realized with jax.sharding +
shard_map; XLA carries the collectives over NVLink via NCCL."""
