"""Smoke test of the renderer on a GPU: the quickest proof the system runs.

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # only the four-GPU phase (sharded frame + train step)

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device: a GPU is required; prints the card's name and power limit.
  2. the packet traversal kernel (ops/packet.py) against the plain XLA
     cluster scan at real widths: shaderballs512 primaries, a divergent
     bounce wavefront, shadow any-hit, exterior720 primaries.
  3. frames through pipeline/frame.make_jitted_frame: kitchen1080,
     shaderballs512, exterior720 (3 frames each; finite colour, mean radiance
     in a stated range; compile seconds, steady ms/frame, memory analysis).
  4. the same frame on the GPU and on the host CPU (cornell256 REFERENCE,
     kitchen 256² RELAX + TAA + SHARC) at "highest" matmul precision.
  5. value_and_grad of the inverse-rendering loss at 512² against central
     finite differences.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench  # noqa: E402  (the bench ladder's scene/camera/config specs)
from nrdsample_tpu.config import (  # noqa: E402
    Denoiser, RenderConfig, Settings, TracingMode,
)
from nrdsample_tpu.ops import cluster, packet, traversal  # noqa: E402
from nrdsample_tpu.pipeline import frame as frame_mod  # noqa: E402
from nrdsample_tpu.pipeline import train as train_mod  # noqa: E402
from nrdsample_tpu.platform import setup_compile_cache  # noqa: E402
from nrdsample_tpu.scene import camera as cam_mod  # noqa: E402
from nrdsample_tpu.scene.types import look_at  # noqa: E402

T_MAX = packet.T_MAX
CARD = ""   # "name, power limit" of the card, set by phase_device

# mean radiance of outputs["color"] after 3 frames, per bench cell: half to
# twice what the H100 rendered, to catch black or blown-up frames
FRAME_MEAN_RANGE = {            # H100 means: 0.2737, 1.0400, 0.6601
    "kitchen1080": (0.14, 0.55),
    "shaderballs512": (0.52, 2.08),
    "exterior720": (0.33, 1.32),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def _require(ok, msg: str) -> None:
    """A failed check ends the run (not an assert: it must survive -O)."""
    if not ok:
        raise RuntimeError(msg)


def phase_device() -> dict:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {CARD}")
    log(f"jax {jax.__version__}; devices {len(jax.devices())} x {dev.device_kind}")
    log(f"compile cache: {setup_compile_cache()}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


@functools.lru_cache(maxsize=None)
def _scene_for(name: str):
    """(spec, contexts, scene, cfg, cam, settings) of a bench cell; built
    once per process."""
    spec = bench._make_configs()[name]
    scene = spec["scene"]()
    if spec.get("glass"):
        ctxs, scene = traversal.build_scene_contexts(scene)
    else:
        ctxs, scene = traversal.build_context(scene)
    cfg = spec["cfg"]
    eye, target, fov = spec["cam"]
    cam = look_at(eye=eye, target=target, fov_y_deg=fov,
                  aspect=cfg.width / cfg.height)
    settings = Settings(**{
        k: (jnp.int32(v) if k == "disable_shadows" else jnp.float32(v))
        for k, v in spec["settings"].items()
    })
    return spec, ctxs, scene, cfg, cam, settings


def _timed(fn, *args, reps: int = 3):
    """(result, compile+first-run seconds, median steady seconds)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def check_hits(label: str, got: dict, ref: dict, t_max) -> None:
    """Hit/miss must agree on every ray, t within 1e-4 relative; a tri
    mismatch is allowed only where both t agree (shared-edge ties)."""
    t, tr = np.asarray(got["t"]), np.asarray(ref["t"])
    tri, tri_r = np.asarray(got["tri"]), np.asarray(ref["tri"])
    hit, hit_r = tri >= 0, tri_r >= 0
    n_flip = int((hit != hit_r).sum())
    both = hit & hit_r
    t_ok = np.abs(t - tr) <= 1e-4 * np.maximum(np.abs(tr), 1e-6)
    n_t = int((both & ~t_ok).sum())
    tri_diff = both & (tri != tri_r)
    n_tri_bad = int((tri_diff & ~t_ok).sum())
    log(f"  {label}: rays={t.size} hits={int(hit_r.sum())} hit/miss "
        f"mismatch={n_flip / t.size:.3e} t-mismatch={n_t / t.size:.3e} "
        f"tri-ties={int(tri_diff.sum()) / t.size:.3e}")
    _require(n_flip == 0, f"{label}: {n_flip} rays differ in hit/miss")
    _require(n_t == 0, f"{label}: {n_t} hit distances differ by > 1e-4 relative")
    _require(n_tri_bad == 0, f"{label}: {n_tri_bad} tri mismatches with unequal t")


def _primaries(cfg, cam):
    pix = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    o, d, _ = cam_mod.camera_rays(cam, cfg.width, cfg.height, pix, jnp.int32(0))
    return o, d


def _compare_traversal(label, cs, tris, o, d, t_max, *, sort=False,
                       any_hit=False):
    """Kernel vs closest_hit_clustered / any_hit_clustered on one launch;
    prints both device times."""
    if any_hit:
        kern = jax.jit(lambda o, d, tm: packet.any_hit_packet(cs, o, d, tm, sort=sort))
        ref = jax.jit(lambda o, d, tm: cluster.any_hit_clustered(cs, tris, o, d, tm))
    else:
        kern = jax.jit(lambda o, d, tm: packet.closest_hit_packet(
            cs, o, d, tm, sort=sort))
        ref = jax.jit(lambda o, d, tm: cluster.closest_hit_clustered(
            cs, tris, o, d, tm))
    got, _, t_k = _timed(kern, o, d, t_max)
    want, _, t_r = _timed(ref, o, d, t_max)
    log(f"  {label}: packet kernel {t_k * 1e3:.3f} ms, XLA cluster scan "
        f"{t_r * 1e3:.3f} ms  [{CARD}]")
    if any_hit:
        b, br = np.asarray(got), np.asarray(want)
        n = int((b != br).sum())
        log(f"  {label}: rays={b.size} blocked={int(br.sum())} mismatch={n / b.size:.3e}")
        _require(n == 0, f"{label}: {n} rays differ in occlusion")
    else:
        check_hits(label, got, want, t_max)
    return got


def phase_kernels() -> None:
    log("phase 2: packet kernel vs XLA cluster scan")
    _, ctx, scene, cfg, cam, settings = _scene_for("shaderballs512")
    cs, tris = ctx.clusters, ctx.tris
    o, d = _primaries(cfg, cam)
    tm = jnp.full((o.shape[0],), T_MAX, jnp.float32)
    prim = _compare_traversal("shaderballs512 primary", cs, tris, o, d, tm)

    # divergent bounce wavefront from the primary hits: random directions in
    # the hemisphere of the geometric normal (the sort=True path)
    hit = prim["tri"] >= 0
    tri = jnp.maximum(prim["tri"], 0)
    n = jnp.cross(tris.e1[tri], tris.e2[tri])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)
    x = o + d * jnp.where(hit, prim["t"], 0.0)[:, None] + n * 1e-3
    rd = jax.random.normal(jax.random.PRNGKey(7), o.shape, jnp.float32)
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    rd = jnp.where(jnp.sum(rd * n, -1, keepdims=True) < 0, -rd, rd)
    _compare_traversal("shaderballs512 bounce (sorted)", cs, tris, x, rd, tm,
                       sort=True)

    # shadow rays toward the sun, bounded t_max (the production any-hit path)
    el, az = np.deg2rad(45.0), np.deg2rad(-147.0)
    sun = jnp.asarray([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                       np.sin(el)], jnp.float32)
    sd = jnp.broadcast_to(sun, x.shape)
    tm_sh = jnp.where(hit, 50.0, 0.0).astype(jnp.float32)
    _compare_traversal("shaderballs512 shadow any-hit", cs, tris, x, sd, tm_sh,
                       sort=True, any_hit=True)

    _, ctxs, scene, cfg, cam, settings = _scene_for("exterior720")
    ctx = ctxs.opaque
    o, d = _primaries(cfg, cam)
    tm = jnp.full((o.shape[0],), T_MAX, jnp.float32)
    log(f"  exterior720: {ctx.clusters.count} clusters, "
        f"{int(ctx.tris.p0.shape[0])} opaque tris")
    _compare_traversal("exterior720 primary", ctx.clusters, ctx.tris, o, d, tm)


def _run_frames(name: str, n_frames: int = 3) -> np.ndarray:
    spec, ctx, scene, cfg, cam, settings = _scene_for(name)
    history = frame_mod.History.create(cfg)
    t0 = time.perf_counter()
    compiled = frame_mod.make_jitted_frame(ctx, cfg).lower(
        scene, cam, settings, history).compile()
    t_compile = time.perf_counter() - t0
    log(f"  {name}: memory {compiled.memory_analysis()}")
    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        out, history = compiled(scene, cam, settings, history)
        jax.block_until_ready((out, history))
        times.append(time.perf_counter() - t0)
    color = np.asarray(out["color"])
    rays = cfg.n_pixels * bench.count_rays_per_pixel(cfg, bool(spec.get("glass")))
    steady = float(np.mean(times[1:]))
    log(f"  {name}: compile {t_compile:.1f} s, steady {steady * 1e3:.2f} ms/frame "
        f"({rays / steady / 1e6:.1f} Mrays/s), frames "
        f"{[round(t * 1e3, 2) for t in times]} ms  [{CARD}]")
    return color


def phase_frames() -> None:
    log("phase 3: frames")
    for name in ("kitchen1080", "shaderballs512", "exterior720"):
        color = _run_frames(name)
        mean = float(color.mean())
        lo, hi = FRAME_MEAN_RANGE[name]
        log(f"  {name}: color {color.shape} mean radiance {mean:.6f} "
            f"(range [{lo}, {hi}])")
        _require(np.isfinite(color).all(), f"{name}: non-finite colour")
        _require(lo <= mean <= hi, f"{name}: mean radiance {mean} outside [{lo}, {hi}]")


def _require_on(device, tree, what: str) -> None:
    """Every array of `tree` lives on `device` (and nowhere else)."""
    places = {d for leaf in jax.tree_util.tree_leaves(tree)
              if isinstance(leaf, jax.Array) for d in leaf.devices()}
    _require(places == {device}, f"{what} on {places}, expected {device}")


def _render_on(device, name: str, cfg, n_frames: int) -> np.ndarray:
    with jax.default_device(device), jax.default_matmul_precision("highest"):
        spec = bench._make_configs()[name]
        ctx, scene = traversal.build_context(spec["scene"]())
        eye, target, fov = spec["cam"]
        cam = look_at(eye=eye, target=target, fov_y_deg=fov,
                      aspect=cfg.width / cfg.height)
        settings = Settings(**{
            k: (jnp.int32(v) if k == "disable_shadows" else jnp.float32(v))
            for k, v in spec["settings"].items()
        })
        frame_fn = frame_mod.make_jitted_frame(ctx, cfg)
        history = frame_mod.History.create(cfg)
        _require_on(device, (ctx.tris, scene, cam, settings, history), "inputs")
        for _ in range(n_frames):
            out, history = frame_fn(scene, cam, settings, history)
        _require_on(device, (out, history), "frame outputs")
        return np.asarray(out["color"])


def compare_images(label: str, got: np.ndarray, ref: np.ndarray) -> None:
    """>= 99.5% of pixels within 1e-3 relative (denominator floored at 1% of
    the image mean, so black pixels compare absolutely) and the image means
    within 1e-4 relative. Reordered sums can flip a few Monte-Carlo hits, so
    a max-abs bound would be unfair."""
    floor = 1e-2 * float(np.abs(ref).mean())
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), floor)
    frac = float((rel.reshape(rel.shape[0], -1).max(axis=-1) <= 1e-3).mean())
    mean_rel = abs(float(got.mean()) - float(ref.mean())) / abs(float(ref.mean()))
    log(f"  {label}: image mean GPU {float(got.mean()):.9f} CPU "
        f"{float(ref.mean()):.9f}; pixels within 1e-3 rel {frac * 100:.3f}%, "
        f"mean rel diff {mean_rel:.3e}, max |diff| "
        f"{float(np.abs(got - ref).max()):.3e}")
    _require(np.isfinite(got).all() and np.isfinite(ref).all(), f"{label}: non-finite")
    _require(frac >= 0.995, f"{label}: only {frac * 100:.3f}% of pixels agree")
    _require(mean_rel <= 1e-4, f"{label}: image means differ by {mean_rel:.3e}")


def phase_cpu_parity() -> None:
    log("phase 4: GPU vs host CPU")
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    cornell = bench._make_configs()["cornell256"]["cfg"]
    kitchen = RenderConfig(
        width=256, height=256, rpp=1, bounce_num=1,
        tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.RELAX,
        use_taa=True, use_sharc=True,
    )
    for label, name, cfg, n in (("cornell256 REFERENCE", "cornell256", cornell, 1),
                                ("kitchen256 RELAX+TAA+SHARC", "kitchen1080", kitchen, 2)):
        compare_images(label, _render_on(gpu, name, cfg, n),
                       _render_on(cpu, name, cfg, n))


def phase_gradient() -> None:
    log("phase 5: value_and_grad at 512^2 vs finite differences")
    r = bench.bench_backward(512, n_iter=1)
    log(f"  forward {r['grad_forward_ms']:.2f} ms, backward "
        f"{r['grad_backward_ms']:.2f} ms, fd rel err {r['grad_fd_rel_err']:.4f}  [{CARD}]")
    _require(r["grad_allclose_fd"], f"gradient vs FD rel err {r['grad_fd_rel_err']}")


FOUR_FRAME = (1920, 1080)
FOUR_TRAIN = (256, 256)
FOUR_LR = 1e-7   # small enough that no update reaches a parameter bound


def _four_setup(width: int, height: int):
    """Shaderballs (a cluster scene: the packet kernel runs inside shard_map)
    with RELAX + TAA + SHARC, so denoiser stencils cross shard boundaries."""
    from nrdsample_tpu.scene import procedural

    ctx, scene = traversal.build_context(procedural.shader_balls(grid=3, sphere_res=24))
    cfg = RenderConfig(
        width=width, height=height, rpp=1, bounce_num=1,
        tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.RELAX,
        use_taa=True, use_sharc=True,
    )
    cam = look_at(eye=[0.0, -9.0, 4.5], target=[0.0, 0.0, 0.8], fov_y_deg=50.0,
                  aspect=width / height)
    settings = Settings(sun_elevation=jnp.float32(45.0))
    return ctx, scene, cfg, cam, settings, frame_mod.History.create(cfg)


def _compile_all(programs: dict) -> dict:
    """name -> (jitted fn, args): trace each in turn, then compile all of
    them at once (XLA compiles outside the GIL), so the wall clock is that of
    the slowest compile rather than the sum."""
    from concurrent.futures import ThreadPoolExecutor

    lowered = {k: fn.lower(*args) for k, (fn, args) in programs.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(lowered)) as ex:
        futures = {k: ex.submit(low.compile) for k, low in lowered.items()}
        compiled = {k: f.result() for k, f in futures.items()}
    log(f"  compiled {', '.join(compiled)} in {time.perf_counter() - t0:.1f} s")
    return compiled


def phase_four(n_dev: int = 4, frame_size=FOUR_FRAME, train_size=FOUR_TRAIN) -> None:
    """Sharded frame (pixels over an n-device mesh, the packet kernel inside
    shard_map) against the single-device frame, and the sharded SGD step of
    the inverse-rendering loss (black target) against the single-device one."""
    from nrdsample_tpu.parallel import mesh as mesh_mod

    log(f"phase four: {n_dev}-device sharded frame and train step")
    _require(len(jax.devices()) >= n_dev, f"need {n_dev} devices, have {len(jax.devices())}")
    mesh = mesh_mod.make_mesh(n_dev)

    ctx, scene, cfg, cam, settings, history = _four_setup(*frame_size)
    frame_args = (scene, cam, settings, history)
    single = jax.jit(lambda s, c, st, h: frame_mod.render_frame(ctx, s, c, cfg, st, h))
    sharded = jax.jit(mesh_mod.sharded_render_fn(ctx, cfg, mesh))
    pixel_idx = mesh_mod.shard_pixels(mesh, cfg.n_pixels)

    tctx, tscene, tcfg, tcam, tsettings, thistory = _four_setup(*train_size)
    target = jnp.zeros((tcfg.n_pixels, 3), tcfg.dtype)
    train_args = (tscene.materials, tscene, tcam, tsettings, thistory)
    target_n = jax.device_put(target, mesh_mod.pixel_sharding(mesh))
    tpix = mesh_mod.shard_pixels(mesh, tcfg.n_pixels)
    compiled = _compile_all({
        "frame single": (single, frame_args),
        "frame sharded": (sharded, frame_args + (pixel_idx,)),
        "train single": (train_mod.make_train_step(tctx, tcfg, lr=FOUR_LR),
                         train_args + (target,)),
        "train sharded": (train_mod.make_sharded_train_step(tctx, tcfg, mesh, lr=FOUR_LR),
                          train_args + (target_n, tpix)),
    })

    (out_1, _), _, t_1 = _timed(compiled["frame single"], *frame_args, reps=2)
    (out_n, _), _, t_n = _timed(compiled["frame sharded"], *frame_args, pixel_idx,
                                reps=2)
    diff = np.abs(np.asarray(out_n["color"]) - np.asarray(out_1["color"]))
    err = float(diff.max())
    log(f"  frame {cfg.width}x{cfg.height}: single {t_1 * 1e3:.2f} ms, "
        f"sharded x{n_dev} {t_n * 1e3:.2f} ms, max |diff| {err:.3e}, values "
        f"off by > 5e-4 {float((diff > 5e-4).mean()):.3e}, by > 0 "
        f"{float((diff > 0).mean()):.3e}  [{CARD}]")
    _require(err < 5e-4, f"sharded-vs-single parity broke: max |diff| = {err}")

    loss_1, mats_1 = compiled["train single"](*train_args, target)
    loss_n, mats_n = compiled["train sharded"](*train_args, target_n, tpix)
    # the SGD update is -lr * grad: compare the updates of every parameter
    fields = train_mod.DIFFERENTIABLE_MATERIAL_FIELDS
    old = {k: np.asarray(getattr(tscene.materials, k)) for k in fields}
    d_1 = {k: np.asarray(getattr(mats_1, k)) - old[k] for k in fields}
    d_n = {k: np.asarray(getattr(mats_n, k)) - old[k] for k in fields}
    scale = max(float(np.abs(d).max()) for d in d_1.values())
    g_err = max(float(np.abs(d_n[k] - d_1[k]).max()) for k in fields) / max(scale, 1e-30)
    loss_1, loss_n = float(loss_1), float(loss_n)
    log(f"  train step {tcfg.width}x{tcfg.height}: loss single {loss_1:.6f} sharded "
        f"{loss_n:.6f}, largest update {scale:.3e}, max update diff / largest "
        f"{g_err:.3e}")
    _require(np.isfinite(loss_n), "sharded train step: non-finite loss")
    _require(all(np.isfinite(d).all() for d in d_n.values()), "non-finite update")
    _require(scale > 0.0, "single-device step moved no parameter")
    _require(abs(loss_n - loss_1) <= 1e-4 * abs(loss_1), "sharded loss differs")
    _require(g_err < 1e-3, f"sharded gradients differ from single-device: {g_err:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase (needs 4 devices)")
    args = ap.parse_args(argv)

    device = phase_device()
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_frames()
        phase_cpu_parity()
        phase_gradient()
    log(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
