"""The one platform decision (nrdsample_tpu/platform.py) and the compile
cache helper every entry point calls."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrdsample_tpu import platform


@pytest.mark.parametrize("backend,expected", [
    ("gpu", True), ("cuda", True), ("cpu", False), ("rocm", False),
    ("tpu", False),
])
def test_decision_from_backend_name(backend, expected):
    assert platform.use_gpu_kernels(backend) is expected


def test_default_is_this_process_backend():
    # the test session runs on the CPU backend: the plain XLA paths
    assert not platform.use_gpu_kernels()


def test_default_device_overrides_backend():
    """A computation placed on the CPU inside a GPU process traces the plain
    paths: the decision follows jax.default_device when one is set."""
    with jax.default_device(jax.devices("cpu")[0]):
        assert not platform.use_gpu_kernels()


def test_cluster_scene_takes_plain_scan_on_cpu():
    """On the CPU, cluster-mode traversal is the XLA cluster scan (no
    pallas_call is traced)."""
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.scene import procedural

    ctx, _ = traversal.build_context(procedural.shader_balls(), mode="cluster")
    o = jnp.zeros((256, 3))
    d = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (256, 1))
    jaxpr = str(jax.make_jaxpr(lambda o, d: traversal.closest_hit(ctx, o, d))(o, d))
    assert "pallas_call" not in jaxpr
    assert not traversal._use_packet(ctx)


def test_dense_scene_has_no_kernel_path():
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.scene import procedural

    ctx, _ = traversal.build_context(procedural.cornell_box())
    assert ctx.mode == "dense" and not traversal._use_packet(ctx)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert platform.setup_compile_cache() == str(tmp_path)
    # nothing set in code when the variable is set
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_checkout_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.setup_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(platform.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_camera_rays_match_float64():
    """Primary ray directions are full f32 (no reduced-precision matmul):
    they match a float64 numpy computation to 1e-6."""
    from nrdsample_tpu.scene import camera as cam_mod
    from nrdsample_tpu.scene.types import look_at

    w, h = 64, 48
    cam = look_at(eye=[0.3, -3.2, 1.1], target=[0.0, 0.0, 1.0], fov_y_deg=39.0,
                  aspect=w / h)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    o, d, uv = cam_mod.camera_rays(cam, w, h, pix, jnp.int32(0))

    px = (np.arange(w * h) % w + 0.5) / w
    py = (np.arange(w * h) // w + 0.5) / h
    t = float(cam.tan_half_fov_y)
    dv = np.stack([(px * 2 - 1) * t * w / h, (1 - py * 2) * t,
                   np.ones_like(px)], axis=-1)
    dv /= np.linalg.norm(dv, axis=-1, keepdims=True)
    r = np.asarray(cam.view_to_world, np.float64)[:3, :3]
    want = dv @ r.T
    want /= np.linalg.norm(want, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(d, np.float64), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(o), np.broadcast_to(
        np.asarray(cam.view_to_world)[:3, 3], o.shape), atol=1e-6)
