"""The one platform decision: which implementation a traced op lowers to.

`use_gpu_kernels()` is True when the computation being traced targets a GPU
(the Pallas/Triton kernels are used, e.g. ops/packet.py) and False otherwise
(the plain XLA paths, which the tests run). There is no third outcome and no
fallback from one to the other. It is read at trace time only: what a scene
build produces does not depend on it.
"""

from __future__ import annotations

import jax


def use_gpu_kernels(backend: str | None = None) -> bool:
    """Whether `backend` (a JAX platform name) takes the GPU kernels. By
    default the target is `jax.default_device` when one is set (so a CPU
    rehearsal inside a GPU process traces the plain paths), else
    `jax.default_backend()`."""
    if backend is None:
        dev = jax.config.jax_default_device
        backend = (getattr(dev, "platform", dev) if dev is not None
                   else jax.default_backend())
    return backend in ("gpu", "cuda")


def setup_compile_cache() -> str:
    """Persistent XLA compile cache for an entry point; returns its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is honoured as JAX reads it and
    nothing else is set here. Otherwise the cache lives at the fixed path
    `<checkout>/.jax_cache` (a fixed path, because the directory is part of
    the cache key)."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path
