"""Möller-Trumbore ray-triangle intersection as a matmul.

The reference evaluates MT per (ray, triangle) pair with cross products
(lib/bvh/triangle.hpp:95-115):

    c = p0 - o;  r = d x c;  det = n . d
    u = (r . e2) / det;  v = (r . e1) / det;  t = (n . c) / det
    accept iff u >= 0, v >= 0, 1-u-v >= 0 (NaN-safe) and tmin <= t <= tmax.

Here every numerator is a *bilinear* form in per-ray and
per-triangle quantities, because r . e2 = d.(p0 x e2) - (d x o).e2 and
n . c = n.p0 - n.o. So with the per-ray feature vector

    f = [d (3), d x o (3), o (3), 1]          (10 dims)

and a per-triangle weight matrix W (10, 4) with output channels
(u_num, v_num, det, t_num), the entire MT numerator set for R rays x T
triangles is ONE matmul  (R,10) @ (10,4T)  — 80 FLOPs/pair, with the
divisions and accept masks as an elementwise epilogue.

Two refinements:
  * Common-origin rays (all primary rays share the camera eye): shift the
    world by the origin so o = 0 and f collapses to [d, 1] (4 dims) —
    32 FLOPs/pair and *better* conditioned than generic MT because the
    large-magnitude d x o terms vanish.
  * Generic rays (shadow/secondary): shift by a scene reference point to
    keep |o| small, avoiding catastrophic cancellation in d x o.

Everything here is pure JAX (differentiable, shardable); the Pallas
megakernel (ceres_tpu.ops.megakernel) consumes the same weights.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ceres_tpu.models.mesh import TriangleSoup

# Matmul precision for intersection tests: float32 throughout. HIGHEST
# keeps the products in true f32 (never TF32 or bf16 passes, which are
# far too coarse for hit distances).
MT_PRECISION = jax.lax.Precision.HIGHEST

# Bound on the elements of one (chunk, 4T) numerator slab of the dense
# test: large scenes get fewer rays per chunk so a chunk fits in memory.
_SLAB_ELEMS = 1 << 28


def _auto_chunk(T: int) -> int:
    """Rays per dense chunk: the largest power of two <= 2048 whose
    (chunk, 4T) numerator slab stays within _SLAB_ELEMS."""
    c = 2048
    while c > 1 and c * 4 * T > _SLAB_ELEMS:
        c //= 2
    return c


class Hit(NamedTuple):
    """Closest-hit result for a wavefront of rays (all shapes (R,))."""

    t: jax.Array
    u: jax.Array
    v: jax.Array
    prim_id: jax.Array  # int32, undefined where mask is False
    mask: jax.Array     # bool


def ray_features(origins: jax.Array, dirs: jax.Array) -> jax.Array:
    """Generic per-ray feature vectors, (R, 10): [d, d x o, o, 1]."""
    ones = jnp.ones(origins.shape[:-1] + (1,), origins.dtype)
    return jnp.concatenate([dirs, jnp.cross(dirs, origins), origins, ones], axis=-1)


def ray_features_common_origin(dirs: jax.Array) -> jax.Array:
    """Feature vectors for rays with origin at the (shifted) world origin: [d, 1]."""
    ones = jnp.ones(dirs.shape[:-1] + (1,), dirs.dtype)
    return jnp.concatenate([dirs, ones], axis=-1)


def triangle_weights(soup: TriangleSoup, origin_shift: Optional[jax.Array] = None) -> jax.Array:
    """Per-triangle MT weight matrices, (T, 10, 4).

    Channels: 0 = u_num, 1 = v_num, 2 = det, 3 = t_num. Ray origins passed to
    :func:`ray_features` must be pre-shifted by the same ``origin_shift``.
    Differentiable w.r.t. the soup fields (and hence vertices).
    """
    p0 = soup.p0 if origin_shift is None else soup.p0 - origin_shift
    e1, e2, n = soup.e1, soup.e2, soup.n
    T = p0.shape[0]
    zeros3 = jnp.zeros_like(p0)
    zeros1 = jnp.zeros((T, 1), p0.dtype)
    # Rows are feature components; build columns (channels) then stack.
    w_u = jnp.concatenate([jnp.cross(p0, e2), -e2, zeros3, zeros1], axis=-1)  # (T, 10)
    w_v = jnp.concatenate([jnp.cross(p0, e1), -e1, zeros3, zeros1], axis=-1)
    w_det = jnp.concatenate([n, zeros3, zeros3, zeros1], axis=-1)
    w_t = jnp.concatenate(
        [zeros3, zeros3, -n, jnp.sum(n * p0, axis=-1, keepdims=True)], axis=-1
    )
    return jnp.stack([w_u, w_v, w_det, w_t], axis=-1)  # (T, 10, 4)


def triangle_weights_common_origin(
    soup: TriangleSoup, origin: jax.Array
) -> jax.Array:
    """Weight matrices for rays that all start at ``origin``, (T, 4, 4).

    Feature layout [d, 1]: u_num = d.(p0' x e2), v_num = d.(p0' x e1),
    det = d.n, t_num = n.p0' with p0' = p0 - origin (so o = 0 exactly).
    """
    p0 = soup.p0 - origin
    e1, e2, n = soup.e1, soup.e2, soup.n
    T = p0.shape[0]
    zeros1 = jnp.zeros((T, 1), p0.dtype)
    w_u = jnp.concatenate([jnp.cross(p0, e2), zeros1], axis=-1)  # (T, 4)
    w_v = jnp.concatenate([jnp.cross(p0, e1), zeros1], axis=-1)
    w_det = jnp.concatenate([n, zeros1], axis=-1)
    w_t = jnp.concatenate(
        [jnp.zeros_like(p0), jnp.sum(n * p0, axis=-1, keepdims=True)], axis=-1
    )
    return jnp.stack([w_u, w_v, w_det, w_t], axis=-1)  # (T, 4, 4)


def mt_numerators(features: jax.Array, weights: jax.Array) -> jax.Array:
    """(R, K) features x (T, K, 4) weights -> (R, T, 4) numerators via one matmul."""
    T, K, _ = weights.shape
    flat = weights.transpose(1, 0, 2).reshape(K, T * 4)
    out = jnp.dot(features, flat, precision=MT_PRECISION)
    return out.reshape(features.shape[0], T, 4)


def decode_hits(
    numerators: jax.Array, tmin, tmax, valid: Optional[jax.Array] = None
):
    """Per-pair accept mask and t/u/v from (..., 4) numerators.

    Returns (t, u, v, accept) where t is +inf for rejected pairs. Reference
    accept semantics (triangle.hpp:106-110): NaN comparisons are False in
    IEEE / XLA, matching the C++ NaN-safe design.
    """
    u_num = numerators[..., 0]
    v_num = numerators[..., 1]
    det = numerators[..., 2]
    t_num = numerators[..., 3]
    # det == 0 (parallel ray, incl. zero-padded rays) must reject cleanly
    # AND stay NaN-free under reverse-mode AD: a plain 1/det would emit
    # inf whose zero cotangent still yields 0 * inf = NaN in the backward
    # scatter. Double-where keeps every intermediate finite.
    degenerate = det == 0
    det_safe = jnp.where(degenerate, 1.0, det)
    inv_det = jnp.where(degenerate, 0.0, 1.0 / det_safe)
    u = u_num * inv_det
    v = v_num * inv_det
    t = t_num * inv_det
    w = 1.0 - u - v
    accept = ((u >= 0) & (v >= 0) & (w >= 0) & (t >= tmin) & (t <= tmax)
              & ~degenerate)
    if valid is not None:
        accept = accept & valid
    return jnp.where(accept, t, jnp.inf), u, v, accept


def _closest_chunk(features, weights, tmin, tmax):
    t, u, v, accept = decode_hits(mt_numerators(features, weights), tmin, tmax)
    prim = jnp.argmin(t, axis=-1).astype(jnp.int32)
    rows = jnp.arange(t.shape[0])
    t_best = t[rows, prim]
    return Hit(t=t_best, u=u[rows, prim], v=v[rows, prim], prim_id=prim,
               mask=jnp.isfinite(t_best))


@functools.partial(jax.jit, static_argnames=("chunk",))
def _closest_hit_jit(features, weights, tmin, tmax, chunk):
    R = features.shape[0]
    if R <= chunk:
        return _closest_chunk(features, weights, tmin, tmax)
    pad = (-R) % chunk
    feats = jnp.pad(features, ((0, pad), (0, 0)))
    feats = feats.reshape(-1, chunk, features.shape[-1])
    # Rematerialized per chunk: the backward pass then holds one chunk's
    # (chunk, T) residuals at a time instead of every chunk's.
    hits = jax.lax.map(
        jax.checkpoint(lambda f: _closest_chunk(f, weights, tmin, tmax)),
        feats)
    return jax.tree.map(lambda x: x.reshape(-1)[:R], hits)


def closest_hit_bruteforce(
    features: jax.Array,
    weights: jax.Array,
    tmin=0.0,
    tmax=jnp.inf,
    chunk: Optional[int] = None,
) -> Hit:
    """Closest hit of R rays against ALL T triangles (no acceleration).

    The mid-level correctness/differentiability reference: chunked over rays
    to bound the (chunk, T) live set (default _auto_chunk(T)). Gradients
    flow to ``features`` and ``weights`` through the selected winners.
    """
    chunk = chunk or _auto_chunk(weights.shape[0])
    dt = features.dtype
    tmin = jnp.asarray(tmin, dt)
    tmax = jnp.asarray(jnp.minimum(jnp.asarray(tmax, dt), jnp.finfo(dt).max), dt)
    return _closest_hit_jit(features, weights, tmin, tmax, chunk)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _any_hit_jit(features, weights, tmin, tmax, chunk):
    def one(f):
        _, _, _, accept = decode_hits(mt_numerators(f, weights), tmin, tmax)
        return jnp.any(accept, axis=-1)

    R = features.shape[0]
    if R <= chunk:
        return one(features)
    pad = (-R) % chunk
    feats = jnp.pad(features, ((0, pad), (0, 0))).reshape(-1, chunk, features.shape[-1])
    return jax.lax.map(one, feats).reshape(-1)[:R]


def any_hit_bruteforce(
    features: jax.Array,
    weights: jax.Array,
    tmin=0.0,
    tmax=jnp.inf,
    chunk: Optional[int] = None,
) -> jax.Array:
    """Occlusion test: (R,) bool, True where a ray hits any triangle."""
    chunk = chunk or _auto_chunk(weights.shape[0])
    dt = features.dtype
    tmin = jnp.asarray(tmin, dt)
    tmax = jnp.asarray(jnp.minimum(jnp.asarray(tmax, dt), jnp.finfo(dt).max), dt)
    return _any_hit_jit(features, weights, tmin, tmax, chunk)
