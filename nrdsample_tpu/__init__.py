"""nrdsample_tpu — a differentiable JAX path tracer + denoiser stack.

A from-scratch JAX/Pallas re-design of the capabilities of NVIDIA-RTX/NRD-Sample
(reference: /root/reference, see SURVEY.md): wavefront path tracing, SHARC-style
hash-grid radiance caching, REBLUR/RELAX/SIGMA/REFERENCE denoisers, TAA and
composition — all expressed as pure, jit-compiled, differentiable functions over
explicit state pytrees, sharded across GPU meshes with `jax.sharding`/`shard_map`.

Layer map (mirrors SURVEY.md §1, re-designed as array programs):
  app/orchestration   -> nrdsample_tpu.cli + pipeline.frame (one jitted frame fn)
  render passes       -> render/* + denoise/* (pure functions, XLA fuses/schedules)
  shared shader lib   -> mathlib/* (ml.hlsli equivalent) + config.py (GlobalConstants)
  external SDKs       -> in-repo: denoise/* (NRD), ops/sharc.py (SHARC),
                         ops/traversal.py (TraceRayInline), scene/bvh.py (driver BVH)
  build/toolchain     -> XLA jit cache; native/ C++ helpers (BVH builder);
                         platform.py (the one GPU/CPU kernel decision)
  data                -> scene/procedural.py + scene/gltf.py
"""

__version__ = "0.1.0"
