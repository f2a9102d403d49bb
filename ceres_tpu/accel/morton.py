"""Morton (Z-order) encoding in pure JAX.

Capability parity with the reference morton machinery
(lib/bvh/morton.hpp:14-60): 10 bits per axis interleaved into a 30-bit code
via log-step mask splits, plus the world->grid quantization the
MortonEncoder performs (grid dimension 2^(bits/3), centers clamped to the
grid). The radix sort the reference pairs with this
(lib/bvh/radix_sort.hpp) is replaced wholesale by ``jnp.argsort`` /
``jax.lax.sort`` — XLA's sort is the device's parallel primitive.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

GRID_BITS = 10  # 10 bits/axis -> 30-bit codes, fits int32
GRID_DIM = 1 << GRID_BITS


def part1by2(x: jax.Array) -> jax.Array:
    """Spread the low 10 bits of ``x`` so each lands every 3rd position.

    The log-step mask sequence mirrors morton_split (morton.hpp:14-32).
    """
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(ix: jax.Array, iy: jax.Array, iz: jax.Array) -> jax.Array:
    """Interleave three 10-bit grid coordinates into a 30-bit Z-order code.

    Bit layout matches morton_encode (morton.hpp:34-40): x in bit 0, y in
    bit 1, z in bit 2 of each triple. Returns int32 (non-negative).
    """
    code = part1by2(ix) | (part1by2(iy) << 1) | (part1by2(iz) << 2)
    return code.astype(jnp.int32)


def quantize(points: jax.Array, lo: jax.Array, hi: jax.Array) -> jax.Array:
    """World-space points -> integer grid coordinates in [0, GRID_DIM).

    The world->grid transform of MortonEncoder (morton.hpp:44-59): scale by
    grid_dim / world extent, clamp into the grid. Degenerate extents (flat
    scenes) map to coordinate 0 on that axis.
    """
    extent = hi - lo
    scale = jnp.where(extent > 0, GRID_DIM / extent, 0.0)
    g = (points - lo) * scale
    return jnp.clip(g.astype(jnp.int32), 0, GRID_DIM - 1)


def morton_codes(points: jax.Array, lo: jax.Array, hi: jax.Array) -> jax.Array:
    """Morton codes for (N, 3) points inside the world bbox [lo, hi]."""
    g = quantize(points, lo, hi)
    return morton_encode(g[:, 0], g[:, 1], g[:, 2])


def morton_order(points: jax.Array) -> jax.Array:
    """Argsort of points along the Z-order curve of their own bbox, (N,) int32.

    The ordering (not the codes) is what clustering and the LBVH consume;
    gradients never flow through it.
    """
    pts = jax.lax.stop_gradient(points)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    codes = morton_codes(pts, lo, hi)
    return jnp.argsort(codes).astype(jnp.int32)
