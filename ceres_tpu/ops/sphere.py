"""Sphere primitive: batched ray-sphere intersection.

Capability parity with bvh::Sphere (lib/bvh/sphere.hpp:13-61): quadratic-
formula intersection with the same accept semantics (nearest root in
[tmin, tmax], fall back to the far root when the near one is behind tmin).
The reference apps never render spheres; the primitive exists in the
library surface, so it exists here — as dense (R, S) pair evaluation (the
sphere count of any plausible scene is tiny next to triangles).
Differentiable w.r.t. centers, radii, and rays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SphereHit(NamedTuple):
    t: jax.Array        # (R,) hit distance, +inf on miss
    sphere_id: jax.Array  # (R,) int32
    mask: jax.Array     # (R,) bool


def intersect_pairs(origins, dirs, centers, radii, tmin=0.0, tmax=jnp.inf):
    """All (ray, sphere) hit distances -> (R, S), +inf where missed.

    Uses the stabilized quadratic: oc = o - c, b = oc.d, disc = b^2 -
    (|oc|^2 - r^2); roots -b -+ sqrt(disc) for normalized d
    (sphere.hpp:33-52 semantics).
    """
    oc = origins[:, None, :] - centers[None, :, :]          # (R, S, 3)
    b = jnp.sum(oc * dirs[:, None, :], axis=-1)             # (R, S)
    c = jnp.sum(oc * oc, axis=-1) - radii[None, :] ** 2
    disc = b * b - c
    ok = disc >= 0
    sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
    t_near = -b - sq
    t_far = -b + sq
    t = jnp.where(t_near >= tmin, t_near, t_far)
    accept = ok & (t >= tmin) & (t <= tmax)
    return jnp.where(accept, t, jnp.inf)


def closest_hit(origins, dirs, centers, radii, tmin=0.0, tmax=jnp.inf) -> SphereHit:
    """Closest sphere per ray (ClosestPrimitiveIntersector semantics)."""
    t = intersect_pairs(origins, dirs, centers, radii, tmin, tmax)
    sid = jnp.argmin(t, axis=-1).astype(jnp.int32)
    t_best = jnp.min(t, axis=-1)
    return SphereHit(t=t_best, sphere_id=sid, mask=jnp.isfinite(t_best))


def any_hit(origins, dirs, centers, radii, tmin=0.0, tmax=jnp.inf):
    """Occlusion against spheres (AnyPrimitiveIntersector semantics)."""
    t = intersect_pairs(origins, dirs, centers, radii, tmin, tmax)
    return jnp.any(jnp.isfinite(t), axis=-1)


def normal_at(point, centers, sphere_id):
    """Outward unit normal of the hit sphere at ``point``."""
    d = point - centers[sphere_id]
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Column (structure-of-arrays) forms for the megakernel render pipeline:
# every op is (R, S)- or (R,)-shaped with no size-3 minor axis. Winner
# attributes come from a one-hot (R, S) @ (S,) matvec instead of a 1-D
# gather.
# ---------------------------------------------------------------------------

def _pairs_cols(o_cols, d_cols, centers, radii, tmin, tmax):
    """(R, S) accepted hit distances from per-ray COLUMN origins/dirs."""
    b = None
    c = None
    for a in range(3):
        oc = o_cols[a][:, None] - centers[None, :, a]       # (R, S)
        b = oc * d_cols[a][:, None] if b is None else \
            b + oc * d_cols[a][:, None]
        c = oc * oc if c is None else c + oc * oc
    c = c - radii[None, :] ** 2
    disc = b * b - c
    ok = disc >= 0
    sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
    t_near = -b - sq
    t_far = -b + sq
    tmin_b = tmin[:, None] if jnp.ndim(tmin) == 1 else tmin
    tmax_b = tmax[:, None] if jnp.ndim(tmax) == 1 else tmax
    t = jnp.where(t_near >= tmin_b, t_near, t_far)
    accept = ok & (t >= tmin_b) & (t <= tmax_b)
    return jnp.where(accept, t, jnp.inf)


def closest_hit_common_origin_cols(eye, dir_cols, centers, radii,
                                   tmin=0.0, tmax=jnp.inf):
    """Closest sphere for common-origin column rays.

    Returns (t (R,), mask (R,), sphere_id (R,) int32, normal — 3-tuple
    of (R,) outward unit-normal columns at the hit points, zeros at
    misses).
    """
    R = dir_cols[0].shape[0]
    o_cols = tuple(jnp.full((R,), eye[a], dir_cols[0].dtype)
                   for a in range(3))
    t = _pairs_cols(o_cols, dir_cols, centers, radii,
                    jnp.asarray(tmin, dir_cols[0].dtype),
                    jnp.asarray(tmax, dir_cols[0].dtype))
    sid = jnp.argmin(t, axis=-1).astype(jnp.int32)
    t_best = jnp.min(t, axis=-1)
    mask = jnp.isfinite(t_best)
    S = centers.shape[0]
    onehot = (jax.lax.broadcasted_iota(jnp.int32, (R, S), 1)
              == sid[:, None]).astype(t.dtype)
    # One-hot winner gather as matvecs, pinned to true f32: a TF32
    # product would round centres and radii to 10 mantissa bits.
    hi = jax.lax.Precision.HIGHEST
    cg = [jnp.matmul(onehot, centers[:, a], precision=hi)
          for a in range(3)]                                  # (R,) matvecs
    rg = jnp.maximum(jnp.matmul(onehot, radii, precision=hi), 1e-30)
    t_safe = jnp.where(mask, t_best, 0.0)
    nrm = tuple(
        jnp.where(mask, (eye[a] + t_safe * dir_cols[a] - cg[a]) / rg, 0.0)
        for a in range(3))
    return t_best, mask, sid, nrm


def any_hit_cols(o_cols, d_cols, centers, radii, tmin=0.0, tmax=jnp.inf):
    """Occlusion against spheres for column rays; tmin/tmax may be
    per-ray (R,) columns (segment shadow tests)."""
    t = _pairs_cols(o_cols, d_cols, centers, radii,
                    jnp.asarray(tmin, o_cols[0].dtype),
                    jnp.asarray(tmax, o_cols[0].dtype))
    return jnp.any(jnp.isfinite(t), axis=-1)
