"""Inner glass-shell synthesis — AddInnerGlassSurfaces parity.

Reference (NRDSample.cpp:2243-2278): for every transparent instance the sample
duplicates it scaled slightly inward, so refraction sees two interfaces
(air->glass, glass->air) and Beer-Lambert absorption gets a real path length —
glTF glass is infinitely thin otherwise. Triggered for BistroInterior at load
(1052-1053).

Layout: the scene is a flat triangle soup, so "instance" is approximated
by the connected transparent group sharing a material id; each group's
triangles are duplicated, scaled toward the group centroid, and flipped
(inward-facing normals), then appended to the soup (host-side numpy, before
build_context).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nrdsample_tpu import config
from nrdsample_tpu.scene.types import Scene, TriangleSoA


def add_inner_glass_surfaces(scene: Scene, thickness: float = 0.05) -> Scene:
    """Append inward-scaled, flipped copies of all transparent triangles.

    thickness: relative inset (0.05 = 5% toward the group centroid — the
    reference uses a fixed uniform scale on the instance transform).
    Host-side numpy; run BEFORE build_context.
    """
    tr = scene.tris
    flags = np.asarray(scene.materials.flags)
    mat = np.asarray(tr.material)
    is_trans = (flags[mat] & config.FLAG_TRANSPARENT) != 0
    if not is_trans.any():
        return scene

    idx = np.nonzero(is_trans)[0]
    p0 = np.asarray(tr.p0)[idx]
    e1 = np.asarray(tr.e1)[idx]
    e2 = np.asarray(tr.e2)[idx]

    # per-material-group centroid (instance proxy)
    group = mat[idx]
    centers = np.zeros((int(mat.max()) + 1, 3), np.float32)
    for g in np.unique(group):
        sel = group == g
        pts = np.concatenate([p0[sel], p0[sel] + e1[sel], p0[sel] + e2[sel]])
        centers[g] = pts.mean(axis=0)
    c = centers[group]

    s = 1.0 - thickness
    # scale all three corners toward the centroid; swap e1/e2 to flip winding
    # (inward-facing normals for the inner shell)
    p0n = c + (p0 - c) * s
    p1n = c + (p0 + e1 - c) * s
    p2n = c + (p0 + e2 - c) * s

    def cat(a, b):
        return np.concatenate([np.asarray(a), b], axis=0)

    n0 = np.asarray(tr.n0)[idx]
    n1 = np.asarray(tr.n1)[idx]
    n2 = np.asarray(tr.n2)[idx]
    new_tris = TriangleSoA(
        p0=cat(tr.p0, p0n.astype(np.float32)),
        e1=cat(tr.e1, (p2n - p0n).astype(np.float32)),   # swapped -> flipped
        e2=cat(tr.e2, (p1n - p0n).astype(np.float32)),
        n0=cat(tr.n0, -n0), n1=cat(tr.n1, -n2), n2=cat(tr.n2, -n1),
        uv0=cat(tr.uv0, np.asarray(tr.uv0)[idx]),
        uv1=cat(tr.uv1, np.asarray(tr.uv2)[idx]),
        uv2=cat(tr.uv2, np.asarray(tr.uv1)[idx]),
        material=cat(tr.material, mat[idx]),
        world_area=cat(tr.world_area, np.asarray(tr.world_area)[idx] * s * s),
        # inner shell: keep tangents, swap t1/t2 with the winding flip
        t0=cat(tr.t0, np.asarray(tr.t0)[idx]),
        t1=cat(tr.t1, np.asarray(tr.t2)[idx]),
        t2=cat(tr.t2, np.asarray(tr.t1)[idx]),
        bitan_sign=cat(tr.bitan_sign, -np.asarray(tr.bitan_sign)[idx]),
    )
    return dataclasses.replace(scene, tris=new_tris)
