"""Per-layer device time of a bench-ladder frame, from a profiler trace.

    python tools/frame_layers.py kitchen1080 shaderballs512 [--plain-traversal]
        [--frames 3] [--out chiprun_out/layers]

Each layer is a `jax.named_scope` on the frame path (trace, traversal,
emissive_probe, sharc_update, trace_transparent, relax, reblur, sigma, taa,
compose, image). The frame is compiled once, traced over `--frames` steady
frames, and every device op event is attributed to the innermost such scope
of its HLO instruction's `op_name` (taken from the compiled module's text).
Prints one JSON line per config: ms per frame for each layer and in total.
--plain-traversal routes cluster scenes through the XLA cluster scan instead
of the packet kernel (the comparison that decides whether the kernel stays).
Needs a GPU; device time is not measured elsewhere.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYERS = ("traversal", "emissive_probe", "sharc_update", "trace_transparent",
          "relax", "reblur", "sigma", "taa", "compose", "trace", "image")
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"(?:calls|body|condition|to_apply)=%?([\w.\-]+)")


def _layer(op_name: str) -> str | None:
    return next((p for p in reversed(op_name.split("/")) if p in LAYERS), None)


def scope_of_ops(hlo_text: str) -> dict:
    """HLO instruction name -> innermost known layer of its op_name. A fusion
    or call without metadata of its own takes the layer of the computation
    it calls. Names are also keyed with '.' -> '_' (kernel-name form)."""
    own, calls, comp_layers = {}, {}, collections.defaultdict(collections.Counter)
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        op = _OPNAME.search(line)
        layer = _layer(op.group(1)) if op else None
        if layer:
            own[name] = layer
            if comp:
                comp_layers[comp][layer] += 1
        callee = _CALLS.search(line)
        if callee:
            calls[name] = callee.group(1)
    out = {}
    for name in set(own) | set(calls):
        layer = own.get(name)
        if layer is None and calls.get(name) in comp_layers:
            layer = comp_layers[calls[name]].most_common(1)[0][0]
        out[name] = layer or "other"
        out[name.replace(".", "_")] = out[name]
    return out


def device_layer_ns(xplane_path: str, scopes: dict) -> tuple[dict, dict]:
    """Sum device kernel durations per layer and per kernel name."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    per, by_op = collections.Counter(), collections.Counter()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # kernels appear once per stream line; the op-level summary lines
            # ("XLA Ops", "XLA Modules", ...) would count them twice
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                op = str(stats.get("hlo_op", ev.name))
                layer = scopes.get(op, scopes.get(ev.name, "other"))
                per[layer] += ev.duration_ns
                by_op[(op, layer)] += ev.duration_ns
    return dict(per), dict(by_op)


def run(name: str, frames: int, out_dir: str, plain: bool) -> dict:
    import jax

    import chip_smoke
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.pipeline import frame as frame_mod

    if plain:
        traversal._use_packet = lambda ctx: False
    spec, ctx, scene, cfg, cam, settings = chip_smoke._scene_for(name)
    history = frame_mod.History.create(cfg)
    compiled = frame_mod.make_jitted_frame(ctx, cfg).lower(
        scene, cam, settings, history).compile()
    scopes = scope_of_ops(compiled.as_text())
    out, history = compiled(scene, cam, settings, history)
    jax.block_until_ready((out, history))
    t0 = time.perf_counter()
    for _ in range(frames):
        out, history = compiled(scene, cam, settings, history)
    jax.block_until_ready((out, history))
    wall = (time.perf_counter() - t0) / frames
    tag = f"{name}{'-plain' if plain else ''}"
    trace_dir = os.path.join(out_dir, tag)
    with jax.profiler.trace(trace_dir):
        for _ in range(frames):
            out, history = compiled(scene, cam, settings, history)
        jax.block_until_ready((out, history))
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))[-1]
    per, by_op = device_layer_ns(path, scopes)
    shutil.rmtree(trace_dir)  # traces are large; the numbers are printed
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    return {
        "config": tag, "card": card, "frame_ms_wall": wall * 1e3,
        "device_ms_per_frame": {k: v / frames / 1e6 for k, v in sorted(per.items())},
        "device_ms_total": sum(per.values()) / frames / 1e6,
        "top_kernels_ms": [
            [op, layer, ns / frames / 1e6]
            for (op, layer), ns in sorted(by_op.items(), key=lambda kv: -kv[1])[:15]
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-layer device time of a frame")
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/layers")
    ap.add_argument("--plain-traversal", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from nrdsample_tpu.platform import setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("frame_layers: needs a GPU")
    setup_compile_cache()
    for name in args.configs:
        print(json.dumps(run(name, args.frames, args.out, args.plain_traversal)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
