"""Golden CPU oracle: brute-force NumPy renderer.

An *independent* implementation of the reference render path
(include/render.hpp:86-156) used only in tests. It follows the C++ structure
directly — per-pair Möller-Trumbore with ``c = p0 - origin`` and explicit
cross products (triangle.hpp:95-115) — rather than the factored matmul
formulation the accelerated path uses, so it cross-checks both the math conventions
and the factored form's numerics. float64 by default for a tight oracle.
"""

from __future__ import annotations

import numpy as np

from ceres_tpu.models import shading as shading_consts


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def intersect_all(origins, dirs, p0, e1, e2, n, tmin=0.0, tmax=np.inf, chunk=1024):
    """Möller-Trumbore of R rays against T triangles, brute force.

    Returns (t, u, v, hit_id, hit_mask) with reference accept semantics
    (triangle.hpp:95-115): u >= 0, v >= 0, 1-u-v >= 0 (NaN-safe), and
    tmin <= t <= tmax. Closest hit via min over triangles. Chunked over rays
    to bound the (R, T) live set.
    """
    R = origins.shape[0]
    if R > chunk:
        outs = [
            intersect_all(origins[s : s + chunk], dirs[s : s + chunk],
                          p0, e1, e2, n, tmin, tmax, chunk)
            for s in range(0, R, chunk)
        ]
        return tuple(np.concatenate([o[k] for o in outs]) for k in range(5))
    o = origins[:, None, :]  # (R, 1, 3)
    d = dirs[:, None, :]
    c = p0[None, :, :] - o                       # (R, T, 3)
    r = np.cross(d, c)                           # (R, T, 3)
    det = np.sum(n[None] * d, axis=-1)           # (R, T)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = 1.0 / det
        u = np.sum(r * e2[None], axis=-1) * inv_det
        v = np.sum(r * e1[None], axis=-1) * inv_det
        t = np.sum(n[None] * c, axis=-1) * inv_det
    w = 1.0 - u - v
    with np.errstate(invalid="ignore"):
        accept = (u >= 0) & (v >= 0) & (w >= 0) & (t >= tmin) & (t <= tmax)
    t_masked = np.where(accept, t, np.inf)
    hit_id = np.argmin(t_masked, axis=-1)
    rows = np.arange(origins.shape[0])
    t_best = t_masked[rows, hit_id]
    hit_mask = np.isfinite(t_best)
    return t_best, u[rows, hit_id], v[rows, hit_id], hit_id, hit_mask


def any_hit(origins, dirs, p0, e1, e2, n, tmin=0.0, tmax=np.inf):
    """Occlusion test: does each ray hit anything at all?"""
    _, _, _, _, mask = intersect_all(origins, dirs, p0, e1, e2, n, tmin, tmax)
    return mask


def render_golden(vertices, faces, eye, cam_dir, up, fov, sun, width, height,
                  mode="smooth", dtype=np.float64, reference_compat=False):
    """Full-pipeline oracle render: returns ((H, W, 3) image, stats dict).

    Mirrors render.hpp:86-156: primary closest hit, hit point offset by
    -1e-5*normalize(n), shadow ray toward the sun (occluded -> black),
    smooth Gouraud shading. ``mode`` in {"smooth", "flat"} ("flat" is the
    |normal| visualization at render.hpp:123-125, used by BASELINE
    config 1). ``reference_compat=True`` reproduces the reference's exact
    barycentric assignment — hit point u*p0 + v*p1 + (1-u-v)*p2
    (render.hpp:127-129) and Gouraud weights (u, v, 1-u-v)
    (render.hpp:76-83) — instead of the default corrected interpolation
    ((1-u-v)*p0 + u*p1 + v*p2, weights (1-u-v, u, v)).
    """
    vertices = np.asarray(vertices, dtype)
    faces = np.asarray(faces)
    eye = np.asarray(eye, dtype)
    sun = np.asarray(sun, dtype)

    p0 = vertices[faces[:, 0]]
    p1 = vertices[faces[:, 1]]
    p2 = vertices[faces[:, 2]]
    e1 = p0 - p1
    e2 = p2 - p0
    n = np.cross(e1, e2)

    # Vertex normals (area-weighted accumulation, obj_norms.hpp:94-111).
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], n)
    lens = np.linalg.norm(vn, axis=-1, keepdims=True)
    vn = vn / np.where(lens > 0, lens, 1.0)
    corner_normals = vn[faces]  # (F, 3, 3)

    # Camera rays (render.hpp:91-113).
    d = normalize(np.asarray(cam_dir, dtype))
    image_w = np.tan(fov * (3.14159265 / 180.0 * 0.5))
    iu = normalize(np.cross(d, up)) * image_w
    iv = normalize(np.cross(np.cross(d, up), d)) * image_w * (height / width)
    ii, jj = np.meshgrid(np.arange(width), np.arange(height))  # (H, W)
    uu = 2 * (ii + 0.5) / width - 1
    vv = 2 * (jj + 0.5) / height - 1
    view = normalize(uu[..., None] * iu + vv[..., None] * iv + d)
    view_flat = view.reshape(-1, 3)
    origins = np.broadcast_to(eye, view_flat.shape)

    t, u, v, hit_id, hit = intersect_all(origins, view_flat, p0, e1, e2, n)

    image = np.zeros((height * width, 3), dtype)
    stats = {"rays": view_flat.shape[0], "hits": int(hit.sum())}

    if not hit.any():
        return image.reshape(height, width, 3), stats

    hi = np.where(hit)[0]
    tri = hit_id[hi]
    hu, hv = u[hi], v[hi]
    hw = 1.0 - hu - hv
    if reference_compat:
        # The reference's exact (mis-assigned) interpolation
        # (render.hpp:127-129).
        point = (hu[:, None] * p0[tri] + hv[:, None] * p1[tri]
                 + hw[:, None] * p2[tri])
    else:
        # True barycentrics (w, u, v) on (p0, p1, p2) — deliberately fixes
        # the reference's mis-assigned interpolation (render.hpp:127-129),
        # see ceres_tpu.render.renderer.
        point = (hw[:, None] * p0[tri] + hu[:, None] * p1[tri]
                 + hv[:, None] * p2[tri])
    point = point + (-1e-5) * normalize(n[tri])
    sun_line = normalize(sun[None, :] - point)
    occluded = any_hit(point, sun_line, p0, e1, e2, n)
    stats["shadow_rays"] = len(hi)
    stats["occluded"] = int(occluded.sum())

    if mode == "flat":
        shade = np.abs(normalize(n[tri]))
        image[hi] = np.where(occluded[:, None], 0.0, shade)
        return image.reshape(height, width, 3), stats

    # Smooth Gouraud shading (render.hpp:57-84).
    cn = corner_normals[tri]  # (K, 3, 3)
    neg_view = -view_flat[hi]
    color = np.zeros((len(hi), 3), dtype)
    # Default: true barycentrics for corners (0, 1, 2); compat: the
    # reference's (u, v, 1-u-v) assignment (render.hpp:76-83).
    weights = [hu, hv, hw] if reference_compat else [hw, hu, hv]
    tint = np.asarray(shading_consts.TINT, dtype)
    for kk in range(3):
        nk = cn[:, kk, :]
        diffuse = shading_consts.DIFFUSE_GAIN * np.abs(np.sum(sun_line * nk, axis=-1))
        h = normalize(sun_line + neg_view)
        spec = shading_consts.SPECULAR_GAIN * np.sum(nk * h, axis=-1) ** shading_consts.SPECULAR_EXP
        base = shading_consts.AMBIENT + diffuse
        rgb = np.clip(base[:, None] * tint + spec[:, None], 0.0, 1.0)
        color += weights[kk][:, None] * rgb
    image[hi] = np.where(occluded[:, None], 0.0, color)
    return image.reshape(height, width, 3), stats
