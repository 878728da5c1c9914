"""Benchmark harness: rays/s on the flagship path-tracing pipeline (GPU).

Prints one JSON line {"metric", "value", "unit", "vs_baseline", "detail"} per
config of the staged BASELINE.md ladder (CornellBox 256² → interior-night
1440p), the headline (shaderballs512) last:
    python bench.py --config cornell256|shaderballs512|kitchen1080|exterior720|interior1440
    python bench.py --all        # every config (the default)

Needs a GPU: it exits non-zero on any other platform. `vs_baseline` is null
until an H100 baseline is set.
"""

from __future__ import annotations

import json
import sys
import time


def count_rays_per_pixel(cfg, has_glass: bool = False) -> float:
    """Full-traversal rays cast per pixel per frame.

    opaque: primary + primary shadow + rpp * bounces * (bounce ray + shadow).
    SHARC probes (1/ds² rate): primary + 4 propagation x (bounce + shadow).
    glass: translucency march + transparent recast + 2 chains x delta bounces
    (world casts) + the single batched 2-chain end shadow.
    Emissive-IS light probes test only the tiny emissive set — not counted.
    """
    from nrdsample_tpu import config as cfgmod

    rays = 2.0 + cfg.rpp * cfg.bounce_num * 2.0
    if cfg.use_sharc:
        rays += (1.0 + 2.0 * cfgmod.SHARC_PROPAGATION_DEPTH) / cfg.sharc_downscale**2
    if has_glass:
        rays += 1.0 + 1.0 + 2.0 * cfg.delta_bounce_num + 2.0
    return rays


def _make_configs():
    """The staged BASELINE.md ladder. Each entry builds (scene_fn, camera,
    RenderConfig, Settings). Scenes are procedural stand-ins at the reference
    scenes' scale (no glTF assets ship with the reference snapshot)."""
    import jax.numpy as jnp

    from nrdsample_tpu.config import (
        Denoiser, NrdMode, RenderConfig, Settings, TracingMode,
    )
    from nrdsample_tpu.scene import procedural

    def cfgbase(w, h, **kw):
        kw.setdefault("tracing_mode", TracingMode.FULL_PROBABILISTIC)
        return RenderConfig(width=w, height=h, **kw)

    return {
        # config 1: CornellBox 256², 1 diffuse bounce, reference accumulation
        "cornell256": dict(
            scene=lambda: procedural.cornell_box(),
            cam=([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
            cfg=cfgbase(256, 256, rpp=1, bounce_num=1, denoiser=Denoiser.REFERENCE),
            settings=dict(sun_elevation=-30.0, disable_shadows=1),
        ),
        # config 2 (headline): ShaderBalls 512², lobe split + ray cones +
        # REBLUR inside the timed frame
        "shaderballs512": dict(
            scene=lambda: procedural.shader_balls(grid=3, sphere_res=24),
            cam=([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], 50.0),
            cfg=cfgbase(512, 512, rpp=1, bounce_num=2, denoiser=Denoiser.REBLUR),
            settings=dict(sun_elevation=45.0),
        ),
        # config 3: Kitchen 1080p, SIGMA + RELAX + SH resolve + TAA + confidence
        "kitchen1080": dict(
            scene=lambda: procedural.kitchen(),
            cam=([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], 65.0),
            cfg=cfgbase(1920, 1080, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX,
                        nrd_mode=NrdMode.SH, use_taa=True, use_sharc=True,
                        use_confidence=True),
            settings=dict(sun_elevation=35.0),
        ),
        # config 4: exterior 720p, SHARC L2 + multi-bounce glass, ~1M tris
        "exterior720": dict(
            scene=lambda: procedural.exterior(
                cobbles=120, tree_count=450, tree_res=28
            ),
            cam=([0.0, -45.0, 6.0], [0.0, 0.0, 4.0], 55.0),
            cfg=cfgbase(1280, 720, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX,
                        use_sharc=True, use_taa=True),
            settings=dict(sun_elevation=30.0),
            glass=True,
        ),
        # config 5: interior-night 1440p, emissive IS, full denoiser stack
        "interior1440": dict(
            scene=lambda: procedural.interior_night(),
            cam=([0.0, -3.5, 1.8], [0.0, 1.5, 1.2], 60.0),
            cfg=cfgbase(2560, 1440, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX,
                        use_sharc=True, use_confidence=True, use_taa=True),
            settings=dict(sun_elevation=-20.0),
        ),
    }


def run_config(name: str, spec: dict, n_iter: int = 8) -> dict:
    import jax
    import jax.numpy as jnp

    from nrdsample_tpu.config import Settings
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.pipeline import frame as frame_mod
    from nrdsample_tpu.scene.types import look_at

    scene = spec["scene"]()
    cfg = spec["cfg"]
    has_glass = bool(spec.get("glass"))
    if has_glass:
        ctx, scene = traversal.build_scene_contexts(scene)
    else:
        ctx, scene = traversal.build_context(scene)
    eye, target, fov = spec["cam"]
    cam = look_at(eye=eye, target=target, fov_y_deg=fov,
                  aspect=cfg.width / cfg.height)
    skw = {
        k: (jnp.int32(v) if k == "disable_shadows" else jnp.float32(v))
        for k, v in spec["settings"].items()
    }
    settings = Settings(**skw)
    history = frame_mod.History.create(cfg)

    # monolithic frame: ONE jit program per frame
    frame_fn = frame_mod.make_jitted_frame(ctx, cfg)

    def step(history):
        out, new_h = frame_fn(scene, cam, settings, history)
        return out["color"], new_h

    color, history = step(history)  # compile + warmup
    jax.block_until_ready((color, history))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        color, history = step(history)
    # block the whole output tree, not one buffer of it
    jax.block_until_ready((color, history))
    dt = (time.perf_counter() - t0) / n_iter

    rays_per_frame = cfg.n_pixels * count_rays_per_pixel(cfg, has_glass)
    rays_per_s = rays_per_frame / dt
    return {
        "metric": "rays_per_second_per_chip",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": None,
        "detail": {
            "config": name,
            "scene_tris": int(scene.num_tris),
            "resolution": f"{cfg.width}x{cfg.height}",
            "rpp": cfg.rpp,
            "bounces": cfg.bounce_num,
            "frame_ms": dt * 1e3,
            "rays_per_pixel": count_rays_per_pixel(cfg, has_glass),
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
        },
    }


def bench_denoise(size: int = 512, n_iter: int = 10) -> dict:
    """Denoise throughput (BASELINE "Mpix/s per chip"): the full RELAX stack on
    one signal at bench resolution."""
    import jax
    import jax.numpy as jnp

    from nrdsample_tpu.denoise import relax

    h = w = size
    key = jax.random.PRNGKey(0)
    rs_img = jax.random.uniform(key, (h, w, 3), jnp.float32)
    vz = jnp.ones((h, w), jnp.float32)
    nrm = jnp.zeros((h, w, 3), jnp.float32).at[..., 2].set(1.0)
    mv = jnp.zeros((h, w, 3), jnp.float32)
    rh = relax.RelaxHistory.create(h, w, jnp.float32)

    # all planes are jit ARGUMENTS, and the history cycles through the step
    # so entry layouts reach steady state
    @jax.jit
    def dn(hist, img, vz, nrm, mv):
        out, new_h = relax.denoise(hist, img, vz, nrm, mv)
        return out, new_h

    out_d, rh = dn(rh, rs_img, vz, nrm, mv)
    out_d, rh = dn(rh, rs_img, vz, nrm, mv)
    jax.block_until_ready((out_d, rh))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out_d, rh = dn(rh, rs_img, vz, nrm, mv)
    jax.block_until_ready((out_d, rh))
    dt_dn = (time.perf_counter() - t0) / n_iter
    return {"denoise_mpix_s": h * w / dt_dn / 1e6, "denoise_ms": dt_dn * 1e3}


def bench_denoise_stack(h: int = 1080, w: int = 1920, n_iter: int = 8) -> dict:
    """The full 1080p image stack — RELAX x2 (diff+spec) + SIGMA + TAA — as
    ONE jitted program on synthetic planes."""
    import jax
    import jax.numpy as jnp

    from nrdsample_tpu.denoise import relax, sigma, taa

    key = jax.random.PRNGKey(0)
    img = jax.random.uniform(key, (h, w, 3), jnp.float32)
    vz = jnp.ones((h, w), jnp.float32)
    nrm = jnp.zeros((h, w, 3), jnp.float32).at[..., 2].set(1.0)
    mv = jnp.zeros((h, w, 3), jnp.float32)
    shadow = (jax.random.uniform(key, (h, w)) > 0.3).astype(jnp.float32)
    shd = jax.random.uniform(key, (h, w)) * 2.0 * (1.0 - shadow)
    hists = (relax.RelaxHistory.create(h, w), relax.RelaxHistory.create(h, w),
             sigma.SigmaHistory.create(h, w), taa.TaaHistory.create(h, w))

    @jax.jit
    def stack(hists, img, vz, nrm, mv, shadow, shd):
        hd, hs, hsig, ht = hists
        d, hd = relax.denoise(hd, img, vz, nrm, mv)
        sp, hs = relax.denoise(hs, img, vz, nrm, mv)
        sh, hsig = sigma.denoise(hsig, shadow, shd, vz, mv, 0.01, 1e-3,
                                 jnp.int32(3))
        out, ht = taa.apply(ht, d + sp * 0.5 + sh[..., None] * 0.1, mv, vz)
        return out, (hd, hs, hsig, ht)

    out, hists = stack(hists, img, vz, nrm, mv, shadow, shd)
    out, hists = stack(hists, img, vz, nrm, mv, shadow, shd)
    jax.block_until_ready((out, hists))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out, hists = stack(hists, img, vz, nrm, mv, shadow, shd)
    jax.block_until_ready((out, hists))
    dt = (time.perf_counter() - t0) / n_iter
    return {"denoise_stack_mpix_s": h * w / dt / 1e6,
            "denoise_stack_ms": dt * 1e3}


def bench_backward(size: int = 512, n_iter: int = 4) -> dict:
    """Backward-pass benchmark (BASELINE "Differentiability" row): times
    `value_and_grad` of the L2 image loss w.r.t. the full differentiable
    material dict at bench scale, reports backward/forward ratio, and checks
    the autodiff gradient of one material parameter against central finite
    differences AT THIS SCALE (test_grad.py covers 32² only)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.pipeline import frame as frame_mod, train as train_mod
    from nrdsample_tpu.scene import procedural
    from nrdsample_tpu.scene.types import look_at

    scene = procedural.shader_balls(grid=3, sphere_res=24)
    ctx, scene = traversal.build_context(scene)
    cfg = RenderConfig(
        width=size, height=size, rpp=1, bounce_num=2,
        tracing_mode=TracingMode.FULL_PROBABILISTIC,
        denoiser=Denoiser.REFERENCE,
    )
    cam = look_at(eye=[0.0, -9.0, 4.5], target=[0.0, 0.0, 0.8], fov_y_deg=50.0)
    settings = Settings(sun_elevation=jnp.float32(45.0))
    history = frame_mod.History.create(cfg)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    loss_fn = train_mod.make_loss_fn(ctx, cfg)
    mat_diff, mat_rest = train_mod.split_materials(scene.materials)

    fwd = jax.jit(loss_fn)
    vag = jax.jit(jax.value_and_grad(loss_fn))

    def time_it(fn, *a):
        r = fn(*a)           # compile + warmup
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            r = fn(*a)
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / n_iter

    args = (mat_diff, mat_rest, scene, cam, settings, history, target)
    t_fwd = time_it(fwd, *args)
    t_vag = time_it(vag, *args)

    # FD check on one material parameter (ball albedo R) at bench scale
    loss0, g = vag(*args)
    idx = (1, 0)
    g_auto = float(g["base_color"][idx])
    eps = 2e-3

    def loss_at(v):
        bc = jnp.asarray(mat_diff["base_color"]).at[idx].set(v)
        return fwd({**mat_diff, "base_color": bc}, *args[1:])

    v0 = float(jnp.asarray(mat_diff["base_color"])[idx])
    g_fd = float((loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps))
    denom = max(abs(g_fd), 1e-6)
    rel_err = abs(g_auto - g_fd) / denom
    return {
        "grad_forward_ms": t_fwd * 1e3,
        "grad_backward_ms": (t_vag - t_fwd) * 1e3,
        "backward_forward_ratio": t_vag / t_fwd,
        "grad_fd_rel_err": rel_err,
        "grad_allclose_fd": bool(rel_err < 0.08),
    }


def main():
    import jax

    from nrdsample_tpu.platform import setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {jax.devices()[0].platform!r}",
              file=sys.stderr)
        return 1
    setup_compile_cache()
    args = sys.argv[1:]
    configs = _make_configs()
    if args and args[0] == "--config":
        names = [args[1]]
    else:
        # default AND --all: the full BASELINE.md ladder, headline last
        names = ["cornell256", "kitchen1080", "exterior720", "interior1440",
                 "shaderballs512"]

    for name in names:
        rec = run_config(name, configs[name])
        if name == "shaderballs512":
            rec["detail"].update(bench_denoise(512))
            rec["detail"].update(bench_backward(512))
        elif name == "kitchen1080":
            rec["detail"].update(bench_denoise_stack(1080, 1920))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
