"""Composable affine transforms for animation keyframing.

Capability parity with the reference Transform (include/transform.hpp:8-129):
a 3x3 matrix ``a`` plus translation ``v`` applied as ``a @ p + v``. The
``rotate`` factor uses the Markley & Crassidis DCM parameterization the
reference cites (transform.hpp:68-107) — note this is the *transpose* of the
usual active Rodrigues matrix, and composition is ``a_new = a_old @ R`` with
the translation left untouched. ``scale`` multiplies the matrix only;
``translate`` adds to ``v`` only. We reproduce those exact semantics.

Implemented as a frozen pytree dataclass so transforms can be traced, vmapped
over keyframe tracks, and differentiated.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def _markley_dcm(axis: jax.Array, angle: jax.Array) -> jax.Array:
    """Rotation factor from transform.hpp:77-97 (radians, row-major)."""
    n = axis / jnp.linalg.norm(axis)
    s = jnp.sin(angle)
    c = jnp.cos(angle)
    x, y, z = n[0], n[1], n[2]
    one_c = 1.0 - c
    return jnp.array(
        [
            [c + one_c * x * x, one_c * x * y + s * z, one_c * x * z - s * y],
            [one_c * y * x - s * z, c + one_c * y * y, one_c * y * z + s * x],
            [one_c * z * x + s * y, one_c * z * y - s * x, c + one_c * z * z],
        ]
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Transform:
    """Affine transform ``p -> a @ p + v`` with reference composition rules."""

    a: jax.Array  # (3, 3)
    v: jax.Array  # (3,)

    @staticmethod
    def identity(dtype=jnp.float32) -> "Transform":
        return Transform(a=jnp.eye(3, dtype=dtype), v=jnp.zeros(3, dtype=dtype))

    def rotate(self, axis, angle) -> "Transform":
        """Compose with a rotation of ``angle`` radians about ``axis``."""
        axis = jnp.asarray(axis, self.a.dtype)
        angle = jnp.asarray(angle, self.a.dtype)
        a = jnp.matmul(self.a, _markley_dcm(axis, angle).astype(self.a.dtype),
                       precision=jax.lax.Precision.HIGHEST)
        return Transform(a=a, v=self.v)

    def scale(self, s) -> "Transform":
        return Transform(a=self.a * jnp.asarray(s, self.a.dtype), v=self.v)

    def translate(self, t) -> "Transform":
        return Transform(a=self.a, v=self.v + jnp.asarray(t, self.v.dtype))

    def __call__(self, p: jax.Array) -> jax.Array:
        """Apply to points of shape (..., 3)."""
        return jnp.matmul(p, self.a.T, precision=jax.lax.Precision.HIGHEST) + self.v


def transform_mesh_vertices(transform: Transform, vertices: jax.Array) -> jax.Array:
    """Apply a Transform to a (V, 3) vertex array (one fused matmul).

    The reference's transform_triangles (transform.hpp:120-129) rebuilds each
    triangle record; here the soup is re-derived from transformed vertices by
    the caller (triangle_soup), keeping everything differentiable.
    """
    return transform(vertices)


def rotate_vertices_about_axis(vertices: jax.Array, axis: int, degrees) -> jax.Array:
    """Axis-aligned mesh rotation matching rotate_triangles<Axis>
    (include/render.hpp:24-44): axis in {0, 1, 2} for X/Y/Z, angle in degrees.
    """
    rad = jnp.asarray(degrees, vertices.dtype) * (3.14159265359 / 180.0)
    c, s = jnp.cos(rad), jnp.sin(rad)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    if axis == 0:
        rot = jnp.array([[one, zero, zero], [zero, c, -s], [zero, s, c]])
    elif axis == 1:
        rot = jnp.array([[c, zero, s], [zero, one, zero], [-s, zero, c]])
    else:
        rot = jnp.array([[c, -s, zero], [s, c, zero], [zero, zero, one]])
    return jnp.matmul(vertices, rot.T.astype(vertices.dtype),
                      precision=jax.lax.Precision.HIGHEST)
