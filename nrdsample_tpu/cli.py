"""CLI harness — the headless frame driver replacing the reference's
window/ImGui app shell (SURVEY.md §2.3 "NRIFramework"/"ImGui"/"cmdline" rows).

Usage:
  python -m nrdsample_tpu.cli render --scene cornellbox --size 256 --frames 16 \
      --bounces 3 --denoiser reference --out /tmp/out.png
  python -m nrdsample_tpu.cli scenes
  python -m nrdsample_tpu.cli bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time


SCENES = {}


def _register_scenes():
    from nrdsample_tpu.scene import procedural

    from nrdsample_tpu.scene import glass_shell

    SCENES.update(
        {
            "cornellbox": lambda: procedural.cornell_box(),
            "cornellbox-furnace": lambda: procedural.cornell_box(furnace=True),
            "cornellbox-glass": lambda: glass_shell.add_inner_glass_surfaces(
                procedural.cornell_box_glass()
            ),
            "shaderballs": lambda: procedural.shader_balls(),
            "kitchen": lambda: procedural.kitchen(),
            "interior-night": lambda: procedural.interior_night(),
            "soup": lambda: procedural.random_soup(100_000),
        }
    )


DEFAULT_CAMERAS = {
    "cornellbox": ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
    "cornellbox-furnace": ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
    "cornellbox-glass": ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
    "shaderballs": ([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], 50.0),
    "kitchen": ([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], 65.0),
    "interior-night": ([0.0, -3.5, 1.8], [0.0, 1.5, 1.2], 60.0),
    "soup": ([0.0, -60.0, 25.0], [0.0, 0.0, 5.0], 55.0),
}


def cmd_render(args) -> int:
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.pipeline import frame as frame_mod
    from nrdsample_tpu.scene.types import look_at
    from nrdsample_tpu.utils import image as image_mod

    from nrdsample_tpu.config import NrdMode, OnScreen

    _register_scenes()
    scene = SCENES[args.scene]()
    eye, target, fov = DEFAULT_CAMERAS[args.scene]
    if args.scene.endswith("-glass"):
        ctx, scene = traversal.build_scene_contexts(scene)
    else:
        ctx, scene = traversal.build_context(scene)
    cam = look_at(eye=eye, target=target, fov_y_deg=fov, aspect=args.size / args.size)
    out_size = args.upscale or 0
    cfg = RenderConfig(
        width=args.size, height=args.size, rpp=args.rpp, bounce_num=args.bounces,
        tracing_mode=TracingMode.FULL_PROBABILISTIC,
        denoiser=Denoiser[args.denoiser.upper()],
        nrd_mode=NrdMode[args.nrd_mode.upper().replace("-", "_")],
        on_screen=OnScreen[args.on_screen.upper().replace("-", "_")],
        use_taa=args.taa,
        use_sharc=args.sharc,
        psr_bounce_num=args.psr,
        output_width=out_size, output_height=out_size,
        use_nis=args.nis,
        use_neural_sr=(args.sr == "neural"),
        enable_post=bool(out_size or args.nis or args.separator > 0.0),
        use_validation_overlay=args.validation,
    )
    settings = Settings(
        sun_azimuth=jnp.float32(args.sun_azimuth),
        sun_elevation=jnp.float32(args.sun_elevation),
        disable_shadows=jnp.int32(1 if args.no_shadows else 0),
        separator=jnp.float32(args.separator),
        exposure=jnp.float32(args.exposure * 100.0),
        forced_material=jnp.int32(
            {"none": 0, "gypsum": 1, "cobalt": 2}[args.forced_material]
        ),
        use_normal_map=jnp.int32(0 if args.no_normal_map else 1),
    )
    print(
        f"scene={args.scene} tris={scene.num_tris} "
        f"mode={getattr(ctx, 'mode', 'opaque+transparent')} "
        f"size={args.size} denoiser={args.denoiser}",
        file=sys.stderr,
    )

    frame_fn = frame_mod.make_jitted_frame(ctx, cfg)
    history = frame_mod.History.create(cfg)
    t0 = time.perf_counter()
    out = None
    for f in range(args.frames):
        out, history = frame_fn(scene, cam, settings, history)
    jax.block_until_ready(out["final"])
    dt = time.perf_counter() - t0
    print(
        f"{args.frames} frames in {dt:.2f}s ({dt/args.frames*1e3:.1f} ms/frame incl. compile)",
        file=sys.stderr,
    )

    if out.get("debug") is not None:
        img = np.asarray(out["debug"]).reshape(args.size, args.size, 3)
        image_mod.write_png(
            args.out, (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        )
    elif cfg.enable_post and out["display"] is not None:
        # post chain already tonemapped + sRGB'd at output resolution
        disp = np.asarray(out["display"])
        image_mod.write_png(args.out, (disp * 255.0 + 0.5).astype(np.uint8))
    else:
        img = np.asarray(out["final"]).reshape(args.size, args.size, 3)
        image_mod.write_png(args.out, image_mod.tonemap_for_display(img, args.exposure))
    print(f"wrote {args.out}")
    return 0


def cmd_animate(args) -> int:
    """Animated render: orbiting instanced cubes over a static scene with
    device-side BLAS refit per frame and true moving-object motion vectors
    (the AnimatedInstance + GatherInstanceData demo, NRDSample.cpp:304-333,
    3395-3630)."""
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.pipeline import frame as frame_mod
    from nrdsample_tpu.scene import animation, instances, procedural
    from nrdsample_tpu.scene.types import Materials, build_triangle_soa, make_scene, look_at
    from nrdsample_tpu.utils import image as image_mod

    # static ground + pool of animated cubes (GenerateAnimatedCubes)
    parts_v, parts_i, mats_id, inst_id = [], [], [], []
    off = 0
    gv, gi = procedural.make_box([0, 0, -1.0], [30, 30, 0.5])
    parts_v.append(gv); parts_i.append(gi); mats_id += [0] * len(gi)
    inst_id += [0] * len(gi)
    off += len(gv)
    for k in range(args.cubes):
        cv, ci = procedural.make_box([0, 0, 0], [0.8, 0.8, 0.8])
        parts_v.append(cv); parts_i.append(ci + off)
        mats_id += [1 + (k % 3)] * len(ci)
        inst_id += [1 + k] * len(ci)
        off += len(cv)
    verts = np.concatenate(parts_v)
    idx = np.concatenate(parts_i)
    tris = build_triangle_soa(verts, idx, None, None, np.array(mats_id, np.int32))
    materials = Materials(
        base_color=np.array(
            [[0.55, 0.55, 0.55], [0.8, 0.25, 0.2], [0.2, 0.6, 0.85], [0.9, 0.75, 0.2]],
            np.float32),
        metalness=np.array([0.0, 0.1, 0.6, 0.9], np.float32),
        roughness=np.array([0.8, 0.4, 0.3, 0.2], np.float32),
        emission=np.zeros((4, 3), np.float32),
        ior=np.full(4, 1.5, np.float32),
        flags=np.full(4, 1, np.int32),
    )
    scene = make_scene(tris, materials)
    ctx, scene = traversal.build_context(scene, mode="cluster")
    inst = instances.assign_instance_ids(scene, np.array(inst_id, np.int32), ctx)
    pool = animation.generate_orbit_pool(args.cubes, extent=6.0, seed=3)
    cam = look_at(eye=[0.0, -16.0, 8.0], target=[0.0, 0.0, 1.0], fov_y_deg=45.0)
    cfg = RenderConfig(
        width=args.size, height=args.size, rpp=1, bounce_num=1,
        tracing_mode=TracingMode.FULL_PROBABILISTIC,
        denoiser=Denoiser[args.denoiser.upper()],
    )
    settings = Settings(sun_elevation=jnp.float32(55.0))

    from functools import lru_cache, partial

    from nrdsample_tpu.pipeline import drs as drs_mod

    @lru_cache(maxsize=None)
    def make_frame_fn(bucket_cfg):
        # one cached jit specialization per DRS bucket (pipeline/drs.py)
        @partial(jax.jit, donate_argnums=(2,))
        def frame_fn(t, t_prev, history, settings):
            # animate -> transform -> refit -> render, one jitted program;
            # prev transforms feed the worldToWorldPrev motion-vector path
            def transforms(tt):
                m = animation.orbit_transforms(pool, tt)
                return jnp.concatenate(
                    [instances.identity_transforms(1), m], axis=0)

            m_curr = transforms(t)
            m_prev = transforms(t_prev)
            world = instances.transform_scene(inst, m_curr)
            ctx2 = instances.refit_context(ctx, world)
            return frame_mod.render_frame(
                ctx2, world, cam, bucket_cfg, settings, history,
                dynamics=(inst, m_curr, m_prev),
            )

        return frame_fn

    ctrl = (drs_mod.DrsController(args.drs_target_ms)
            if args.drs_target_ms > 0 else None)
    cur_cfg = drs_mod.bucket_cfg(cfg, ctrl.scale) if ctrl else cfg
    hist = frame_mod.History.create(cur_cfg)
    import time as _time

    from nrdsample_tpu.pipeline import adaptive

    timer = adaptive.FrameTimer()
    t0 = _time.perf_counter()
    out = None
    prev_settings = None
    for f in range(args.frames):
        t = f / 24.0
        tf0 = _time.perf_counter()
        # adaptive accumulation (NRDSample.cpp:2139-2189): the cap is a traced
        # Settings scalar, so updating it does NOT retrace the frame
        settings = adaptive.update(settings, prev_settings, timer.smoothed_ms)
        prev_settings = settings
        out, hist = make_frame_fn(cur_cfg)(
            jnp.float32(t), jnp.float32(max(t - 1 / 24.0, 0.0)), hist, settings)
        if f > 0:
            if ctrl is None:
                jax.block_until_ready(out["final"])
            timer.update((_time.perf_counter() - tf0) * 1e3)
        if ctrl is not None:
            jax.block_until_ready(out["display"])
            scale = ctrl.update((_time.perf_counter() - tf0) * 1e3)
            next_cfg = drs_mod.bucket_cfg(cfg, scale)
            if next_cfg is not cur_cfg and next_cfg != cur_cfg:
                print(f"frame {f}: DRS -> {next_cfg.width}x{next_cfg.height}",
                      file=sys.stderr)
                hist = drs_mod.resize_history(hist, cur_cfg, next_cfg)
                cur_cfg = next_cfg
    key = "display" if ctrl is not None else "final"
    jax.block_until_ready(out[key])
    dt = _time.perf_counter() - t0
    print(f"{args.frames} animated frames in {dt:.2f}s "
          f"({dt/args.frames*1e3:.1f} ms/frame incl. compile)", file=sys.stderr)
    img = np.asarray(out[key])
    if ctrl is None:
        img = img.reshape(args.size, args.size, 3)  # "final" is flat (N, 3)
    image_mod.write_png(args.out, image_mod.tonemap_for_display(img, 0.6))
    print(f"wrote {args.out}")
    return 0


def cmd_optimize(args) -> int:
    """Inverse rendering: recover perturbed material parameters from a target
    render (the BASELINE config-5 differentiable-optimization demo)."""
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import dataclasses as dc

    import jax.numpy as jnp
    import numpy as np

    from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.pipeline import frame as frame_mod, train as train_mod
    from nrdsample_tpu.scene.types import look_at

    _register_scenes()
    scene = SCENES[args.scene]()
    eye, target_pt, fov = DEFAULT_CAMERAS[args.scene]
    ctx, scene = traversal.build_context(scene)
    cam = look_at(eye=eye, target=target_pt, fov_y_deg=fov)
    cfg = RenderConfig(
        width=args.size, height=args.size, rpp=1, bounce_num=1,
        tracing_mode=TracingMode.FULL_PROBABILISTIC,
        denoiser=Denoiser.REFERENCE,
    )
    settings = Settings(
        sun_elevation=jnp.float32(args.sun_elevation),
        disable_shadows=jnp.int32(1),
    )

    # ground-truth image with the TRUE materials
    hist = frame_mod.History.create(cfg)
    target, _ = train_mod.render_color(
        ctx, cfg, scene.materials, scene, cam, settings, hist
    )
    target = jax.lax.stop_gradient(target)

    # perturb the albedo and recover it
    rs = np.random.RandomState(0)
    bc_true = np.asarray(scene.materials.base_color)
    bc0 = np.clip(bc_true + rs.uniform(-0.3, 0.3, bc_true.shape), 0.05, 0.95)
    materials = dc.replace(scene.materials, base_color=jnp.asarray(bc0.astype(np.float32)))

    step = train_mod.make_train_step(ctx, cfg, lr=args.lr)
    err0 = float(np.abs(bc0 - bc_true).mean())
    loss = None
    for it in range(args.iters):
        loss, materials = step(materials, scene, cam, settings, hist, target)
        if it % max(args.iters // 10, 1) == 0:
            err = float(np.abs(np.asarray(materials.base_color) - bc_true).mean())
            print(f"iter {it:4d}  loss {float(loss):.6f}  albedo_err {err:.4f}",
                  file=sys.stderr)
    err1 = float(np.abs(np.asarray(materials.base_color) - bc_true).mean())
    print(json.dumps({
        "initial_albedo_error": err0,
        "final_albedo_error": err1,
        "final_loss": float(loss),
        "recovered": err1 < err0 * 0.5,
    }))
    return 0 if err1 < err0 * 0.5 else 1


def cmd_scenes(_args) -> int:
    _register_scenes()
    for name in SCENES:
        print(name)
    return 0


def cmd_bench(_args) -> int:
    import runpy

    runpy.run_path("bench.py", run_name="__main__")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nrdsample_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="cornellbox", choices=list(DEFAULT_CAMERAS))
    r.add_argument("--size", type=int, default=256)
    r.add_argument("--frames", type=int, default=16)
    r.add_argument("--rpp", type=int, default=1)
    r.add_argument("--bounces", type=int, default=2)
    r.add_argument("--denoiser", default="reference",
                   choices=["reblur", "relax", "reference"])
    r.add_argument("--taa", action="store_true")
    r.add_argument("--out", default="/tmp/render.png")
    r.add_argument("--exposure", type=float, default=0.35)
    r.add_argument("--sun-azimuth", type=float, default=-147.0)
    r.add_argument("--sun-elevation", type=float, default=45.0)
    r.add_argument("--no-shadows", action="store_true")
    r.add_argument("--forced-material", default="none",
                   choices=["none", "gypsum", "cobalt"],
                   help="debug material override (RaytracingShared.hlsli:497-515)")
    r.add_argument("--cpu", action="store_true", help="force CPU backend")
    r.add_argument("--nrd-mode", default="normal",
                   choices=["normal", "sh", "occlusion", "directional-occlusion"])
    r.add_argument("--sharc", action="store_true", help="SHARC L2 radiance cache")
    r.add_argument("--psr", type=int, default=0, help="PSR mirror-walk bounces")
    r.add_argument("--upscale", type=int, default=0,
                   help="output resolution (SR slot; 0 = native)")
    r.add_argument("--sr", default="lanczos", choices=["lanczos", "neural"],
                   help="SR-slot kernel: classical Lanczos-2 or the learned "
                        "residual CNN (falls back to Lanczos if weights absent)")
    r.add_argument("--nis", action="store_true", help="NIS-style sharpen")
    r.add_argument("--separator", type=float, default=0.0,
                   help="split-screen noisy|denoised separator in [0,1]")
    r.add_argument("--validation", action="store_true",
                   help="NRD validation-layer overlay (accumulation-age "
                        "heatmap over the final image)")
    r.add_argument("--no-normal-map", action="store_true",
                   help="disable normal mapping (gUseNormalMap off)")
    r.add_argument("--on-screen", default="final",
                   help="debug view (gOnScreen): final, base-color, normal, "
                        "roughness, metalness, shadow, material-id, uv, "
                        "curvature, mip-primary, instance-index, "
                        "ambient-occlusion, denoised-diffuse, sharc-cache, "
                        "sharc-grid, taa-weight, ...")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate", help="animated orbiting-cubes demo (BLAS refit)")
    a.add_argument("--size", type=int, default=128)
    a.add_argument("--frames", type=int, default=24)
    a.add_argument("--cubes", type=int, default=12)
    a.add_argument("--denoiser", default="relax",
                   choices=["reblur", "relax", "reference"])
    a.add_argument("--out", default="/tmp/animate.png")
    a.add_argument("--drs-target-ms", type=float, default=0.0,
                   help="enable dynamic resolution: target frame time in ms "
                        "(bucketed render rect, pipeline/drs.py; 0 = off)")
    a.add_argument("--cpu", action="store_true")
    a.set_defaults(fn=cmd_animate)

    o = sub.add_parser("optimize", help="inverse-rendering demo (recover albedo)")
    o.add_argument("--scene", default="cornellbox", choices=list(DEFAULT_CAMERAS))
    o.add_argument("--size", type=int, default=48)
    o.add_argument("--iters", type=int, default=200)
    o.add_argument("--lr", type=float, default=4e-4,
                   help="SGD lr; the loss sums over pixels, scale ~1/n_pixels")
    o.add_argument("--sun-elevation", type=float, default=-30.0)
    o.add_argument("--cpu", action="store_true")
    o.set_defaults(fn=cmd_optimize)

    s = sub.add_parser("scenes", help="list scenes")
    s.set_defaults(fn=cmd_scenes)

    b = sub.add_parser("bench", help="run the benchmark")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from nrdsample_tpu.platform import setup_compile_cache

    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
