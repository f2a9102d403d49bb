"""Pinhole camera and ray generation.

Reproduces the reference camera model exactly (include/render.hpp:16-22,91-113):

  dir      = normalize(camera.dir)
  image_u  = normalize(cross(dir, up)) * tan(fov * pi/360)
  image_v  = normalize(cross(image_u, dir)) * tan(fov * pi/360) * (h / w)
  u(i)     = 2 * (i + 0.5) / w - 1      (i along width)
  v(j)     = 2 * (j + 0.5) / h - 1      (j along height)
  ray      = (eye, normalize(u * image_u + v * image_v + dir))

Everything is pure JAX and differentiable w.r.t. eye, dir, up and fov.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_PI = 3.14159265


def _normalize(v: jax.Array) -> jax.Array:
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera (reference: include/render.hpp:16-22)."""

    eye: jax.Array  # (3,)
    dir: jax.Array  # (3,) need not be normalized
    up: jax.Array   # (3,)
    fov: jax.Array  # scalar, degrees (full horizontal field of view)

    @staticmethod
    def make(eye, dir, up, fov, dtype=jnp.float32) -> "Camera":
        return Camera(
            eye=jnp.asarray(eye, dtype),
            dir=jnp.asarray(dir, dtype),
            up=jnp.asarray(up, dtype),
            fov=jnp.asarray(fov, dtype),
        )


def camera_basis(camera: Camera, width: int, height: int):
    """(dir, image_u, image_v) of the image plane (render.hpp:91-97)."""
    d = _normalize(camera.dir)
    image_w = jnp.tan(camera.fov * (_PI / 180.0 * 0.5))
    iu = _normalize(jnp.cross(d, camera.up)) * image_w
    iv = _normalize(jnp.cross(jnp.cross(d, camera.up), d)) * image_w * (height / width)
    return d, iu, iv


def camera_rays_rows(
    camera: Camera, width: int, height: int, row_start, num_rows: int
) -> jax.Array:
    """Normalized view directions for pixel rows [row_start, row_start+num_rows).

    Shape (num_rows, width, 3). ``row_start`` may be traced — this is the
    on-device ray generator each chip uses for its own row shard, so no ray
    data ever crosses the host (SURVEY.md §7 hard part (e)).
    """
    d, iu, iv = camera_basis(camera, width, height)
    i = jnp.arange(width, dtype=camera.eye.dtype)
    j = row_start + jnp.arange(num_rows, dtype=camera.eye.dtype)
    u = 2.0 * (i + 0.5) / width - 1.0
    v = 2.0 * (j + 0.5) / height - 1.0
    dirs = (
        u[None, :, None] * iu[None, None, :]
        + v[:, None, None] * iv[None, None, :]
        + d[None, None, :]
    )
    return _normalize(dirs)


def camera_ray_columns(camera: Camera, width: int, height: int):
    """Normalized view directions as 3 separate (height, width) planes.

    The structure-of-arrays form of :func:`camera_rays`: every op is a
    dense (H, W) op, with no minor dimension of size 3. Same math, same
    pixel-center convention (render.hpp:105-113).
    """
    d, iu, iv = camera_basis(camera, width, height)
    i = jnp.arange(width, dtype=camera.eye.dtype)
    j = jnp.arange(height, dtype=camera.eye.dtype)
    u = (2.0 * (i + 0.5) / width - 1.0)[None, :]    # (1, W)
    v = (2.0 * (j + 0.5) / height - 1.0)[:, None]   # (H, 1)
    cols = tuple(u * iu[a] + v * iv[a] + d[a] for a in range(3))
    inv = jax.lax.rsqrt(cols[0] * cols[0] + cols[1] * cols[1]
                        + cols[2] * cols[2])
    return tuple(c * inv for c in cols)


def camera_rays(camera: Camera, width: int, height: int) -> jax.Array:
    """Normalized view directions for every pixel, shape (height, width, 3).

    Row j / column i of the result is the ray for pixel (i, j) in the
    reference's indexing (render.hpp:105-113): the pixel buffer there is
    laid out ``index = width * j + i``, i.e. row-major over j.
    All rays share origin ``camera.eye``.
    """
    d, iu, iv = camera_basis(camera, width, height)
    i = jnp.arange(width, dtype=camera.eye.dtype)
    j = jnp.arange(height, dtype=camera.eye.dtype)
    u = 2.0 * (i + 0.5) / width - 1.0    # (W,)
    v = 2.0 * (j + 0.5) / height - 1.0   # (H,)
    dirs = (
        u[None, :, None] * iu[None, None, :]
        + v[:, None, None] * iv[None, None, :]
        + d[None, None, :]
    )
    return _normalize(dirs)
