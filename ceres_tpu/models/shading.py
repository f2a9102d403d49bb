"""Shading models: Lambertian, Blinn-Phong, Gouraud-interpolated smooth shading.

Reproduces the reference shading math and constants exactly
(include/render.hpp:46-84): ambient 0.2, diffuse 0.5 * |dot(sun, n)|,
specular 0.8 * dot(n, normalize(sun + view))^24, channel tint
(0.5, 0.0, 0.8) applied to (ambient + diffuse) only, clamp to [0, 1]
per corner, then blended with barycentric weights (u, v, 1 - u - v).

All functions are pure JAX, broadcast over leading batch dims, and
differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

AMBIENT = 0.2
DIFFUSE_GAIN = 0.5
SPECULAR_GAIN = 0.8
SPECULAR_EXP = 24
TINT = (0.5, 0.0, 0.8)


def _normalize(v: jax.Array) -> jax.Array:
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def lambertian(sun_line: jax.Array, normal: jax.Array) -> jax.Array:
    """|dot(sun_line, normal)| (render.hpp:46-49). Shapes (..., 3) -> (...)."""
    return jnp.abs(jnp.sum(sun_line * normal, axis=-1))


def blinn_phong_spec(sun_line: jax.Array, normal: jax.Array, view: jax.Array) -> jax.Array:
    """dot(normal, normalize(sun_line + view))^24 (render.hpp:51-54).

    The exponent is an even integer, so negative bases come out positive —
    matching C++ std::pow semantics on the reference path.
    """
    h = _normalize(sun_line + view)
    return jnp.sum(normal * h, axis=-1) ** SPECULAR_EXP


def corner_shade(sun_line: jax.Array, normal: jax.Array, view: jax.Array) -> jax.Array:
    """Color contribution of one corner normal before barycentric weighting.

    Returns (..., 3) RGB. ``view`` here is the *negated* primary-ray view
    direction, as the reference passes ``view * -1`` (render.hpp:66,72,78).
    """
    diffuse = DIFFUSE_GAIN * lambertian(sun_line, normal)
    specular = SPECULAR_GAIN * blinn_phong_spec(sun_line, normal, view)
    base = AMBIENT + diffuse
    tint = jnp.asarray(TINT, dtype=base.dtype)
    rgb = base[..., None] * tint + specular[..., None]
    return jnp.clip(rgb, 0.0, 1.0)


def smooth_shading(
    sun_line: jax.Array,      # (..., 3), normalized direction toward the sun
    corner_normals: jax.Array,  # (..., 3, 3): normals of corners 0,1,2
    view: jax.Array,          # (..., 3), primary-ray direction (un-negated)
    u: jax.Array,             # (...)
    v: jax.Array,             # (...)
    reference_compat: bool = False,
) -> jax.Array:
    """Gouraud smooth shading (render.hpp:57-84).

    Corner weights are (1-u-v, u, v) for corners (0, 1, 2) in OBJ winding
    order — the *true* barycentrics of the reference's MT variant. NOTE:
    the reference itself weights corners (u, v, 1-u-v) (render.hpp:76-83),
    a mis-assignment matching its hit-point bug (see
    ceres_tpu.render.renderer); we interpolate correctly by default, which
    makes shading C0-continuous across shared mesh edges.
    ``reference_compat=True`` reproduces the reference's exact (u, v, 1-u-v)
    assignment instead.
    """
    neg_view = -view
    c0 = corner_shade(sun_line, corner_normals[..., 0, :], neg_view)
    c1 = corner_shade(sun_line, corner_normals[..., 1, :], neg_view)
    c2 = corner_shade(sun_line, corner_normals[..., 2, :], neg_view)
    w = 1.0 - u - v
    w0, w1, w2 = (u, v, w) if reference_compat else (w, u, v)
    return w0[..., None] * c0 + w1[..., None] * c1 + w2[..., None] * c2


def flat_shading(normal: jax.Array) -> jax.Array:
    """|n| visualization used by the reference's flat path (render.hpp:123-125):
    RGB = abs(normalize(face_normal)). Shapes (..., 3) -> (..., 3)."""
    return jnp.abs(_normalize(normal))


# ---------------------------------------------------------------------------
# Column (structure-of-arrays) forms — the megakernel pipeline's path.
# Mathematically identical to the (..., 3) forms above, but every op is a
# flat (R,) vector op, with no reduction over a size-3 minor axis.
# ---------------------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize3(v, guard=None):
    """Columns -> normalized columns; ``guard`` masks rows whose length may
    be zero (padding/miss rows) to keep NaNs out of forward AND backward."""
    sq = _dot3(v, v)
    if guard is not None:
        sq = jnp.where(guard, sq, 1.0)
    inv = jax.lax.rsqrt(sq)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _corner_shade_cols(sun, n, neg_view):
    """corner_shade in column form: 3x (R,) -> 3x (R,) RGB."""
    lamb = jnp.abs(_dot3(sun, n))
    h = _normalize3((sun[0] + neg_view[0], sun[1] + neg_view[1],
                     sun[2] + neg_view[2]))
    nh = _dot3(n, h)
    spec = SPECULAR_GAIN * nh ** SPECULAR_EXP
    base = AMBIENT + DIFFUSE_GAIN * lamb
    return tuple(jnp.clip(base * TINT[a] + spec, 0.0, 1.0) for a in range(3))


def smooth_shading_cols(sun_line, corner_cols, view, u, v,
                        reference_compat: bool = False):
    """Gouraud smooth shading, column form (render.hpp:57-84).

    sun_line/view: 3-tuples of (R,); corner_cols: sequence of 9 (R,)
    corner-normal columns [n0 | n1 | n2] (per-column winner-gather
    payload).
    Returns 3-tuple of (R,) RGB columns. Same corner-weight convention as
    :func:`smooth_shading` (w, u, v) — see that docstring for the
    documented deviation from render.hpp:76-83 and the
    ``reference_compat`` switch that reproduces it.
    """
    neg_view = (-view[0], -view[1], -view[2])
    cs = [
        _corner_shade_cols(
            sun_line,
            (corner_cols[3 * k], corner_cols[3 * k + 1],
             corner_cols[3 * k + 2]),
            neg_view)
        for k in range(3)
    ]
    w = 1.0 - u - v
    w0, w1, w2 = (u, v, w) if reference_compat else (w, u, v)
    return tuple(w0 * cs[0][a] + w1 * cs[1][a] + w2 * cs[2][a]
                 for a in range(3))


def flat_shading_cols(n, guard=None):
    """flat_shading in column form: abs(normalize(n)) per column."""
    nn = _normalize3(n, guard=guard)
    return tuple(jnp.abs(c) for c in nn)
