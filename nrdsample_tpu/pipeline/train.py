"""Differentiable inverse-rendering training step, single- and multi-chip.

This is the BASELINE.json north-star requirement the reference never had: pixel
gradients flow back to material albedo/roughness/metalness, emissive radiance
and sun parameters; on a mesh, rays are sharded and scene-parameter gradients
are all-reduced (`psum`) across devices (SURVEY.md §2.4 (b)).

Discrete decisions (hit selection, lobe choice) are detached; gradients flow
through the continuous shading factors (SURVEY.md §7.1 "Differentiability").
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nrdsample_tpu.pipeline import frame as frame_mod


DIFFERENTIABLE_MATERIAL_FIELDS = ("base_color", "metalness", "roughness", "emission", "ior")


def split_materials(materials):
    """Split Materials into (differentiable dict, static dict) — int flags can't
    be grad inputs."""
    import dataclasses as dc

    diff = {k: getattr(materials, k) for k in DIFFERENTIABLE_MATERIAL_FIELDS}
    rest = {
        f.name: getattr(materials, f.name)
        for f in dc.fields(materials)
        if f.name not in DIFFERENTIABLE_MATERIAL_FIELDS
    }
    return diff, rest


def merge_materials(diff: dict, rest: dict):
    from nrdsample_tpu.scene.types import Materials

    return Materials(**diff, **rest)


def render_color(ctx, cfg, materials, scene, cam, settings, history, pixel_idx=None):
    scene = dataclasses.replace(scene, materials=materials)
    out, new_h = frame_mod.render_frame(
        ctx, scene, cam, cfg, settings, history, pixel_idx=pixel_idx
    )
    return out["color"], new_h


def make_loss_fn(ctx, cfg):
    """L2 image loss vs a target, as a function of the *differentiable* material
    dict (see split_materials)."""

    def loss_fn(mat_diff, mat_rest, scene, cam, settings, history, target,
                pixel_idx=None):
        materials = merge_materials(mat_diff, mat_rest)
        color, _ = render_color(
            ctx, cfg, materials, scene, cam, settings, history, pixel_idx
        )
        err = color - target
        return jnp.sum(err * err)

    return loss_fn


PARAM_BOUNDS = {
    "base_color": (0.0, 1.0),
    "metalness": (0.0, 1.0),
    "roughness": (0.01, 1.0),
    "emission": (0.0, 1e4),
    "ior": (1.0, 2.5),
}


def project_materials(diff: dict) -> dict:
    """Clamp optimized parameters into their physical ranges (projection step;
    keeps long SGD runs from walking into NaN-producing regions)."""
    return {
        k: jnp.clip(v, *PARAM_BOUNDS[k]) if k in PARAM_BOUNDS else v
        for k, v in diff.items()
    }


def make_train_step(ctx, cfg, lr: float = 0.05):
    """Single-chip SGD step on material parameters. NOTE: the loss is a SUM
    over pixels, so a stable lr scales like 1/n_pixels (the inverse-rendering
    tests use 2e-4 at 32x32)."""
    loss_fn = make_loss_fn(ctx, cfg)

    @jax.jit
    def step(materials, scene, cam, settings, history, target):
        mat_diff, mat_rest = split_materials(materials)
        loss, g = jax.value_and_grad(loss_fn)(
            mat_diff, mat_rest, scene, cam, settings, history, target
        )
        new_diff = jax.tree.map(lambda p, gr: p - lr * gr, mat_diff, g)
        return loss, merge_materials(project_materials(new_diff), mat_rest)

    return step


def make_sharded_loss_fn(ctx, cfg, mesh):
    """make_loss_fn over the TWO-PHASE sharded frame
    (parallel.mesh.sharded_render_fn): rays shard over `px` inside shard_map,
    the denoiser stack runs on global row-sharded images, and the loss reduces
    over the sharded pixel dim — GSPMD inserts the gradient all-reduce (the
    psum, over NVLink via NCCL on GPUs) in the backward sweep.

    The differentiated pipeline is the SAME pipeline the single device runs
    (sharded == unsharded parity). pixel_idx is a required argument."""
    from nrdsample_tpu.parallel.mesh import sharded_render_fn

    render_fn = sharded_render_fn(ctx, cfg, mesh)

    def loss_fn(mat_diff, mat_rest, scene, cam, settings, history, target,
                pixel_idx):
        materials = merge_materials(mat_diff, mat_rest)
        scene = dataclasses.replace(scene, materials=materials)
        out, _ = render_fn(scene, cam, settings, history, pixel_idx)
        err = out["color"] - target
        return jnp.sum(err * err)

    return loss_fn


def make_sharded_train_step(ctx, cfg, mesh, lr: float = 0.05):
    """Multi-device training step: SGD on make_sharded_loss_fn."""
    loss_fn = make_sharded_loss_fn(ctx, cfg, mesh)

    @jax.jit
    def step(materials, scene, cam, settings, history, target, pixel_idx):
        mat_diff, mat_rest = split_materials(materials)
        loss, g = jax.value_and_grad(loss_fn)(
            mat_diff, mat_rest, scene, cam, settings, history, target, pixel_idx
        )
        new_diff = jax.tree.map(lambda p, gr: p - lr * gr, mat_diff, g)
        return loss, merge_materials(project_materials(new_diff), mat_rest)

    return step
