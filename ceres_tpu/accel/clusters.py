"""Morton-ordered triangle clusters — the acceleration structure.

The reference accelerates rays with a binary BVH traversed by a per-ray
stack (lib/bvh/bvh.hpp:18-97, single_ray_traverser.hpp:67-126) — divergent
pointer-chasing that maps badly onto lockstep vector hardware. The
replacement here flattens the hierarchy into *clusters*: fixed-size
groups of C spatially-coherent triangles (C = 128 by default), formed by sorting triangle centroids along the Morton curve. Each cluster
carries one AABB; a ray tile slab-tests a cluster's AABB (cheap, fully
vectorized) and only on overlap runs the dense Möller-Trumbore matmul
against all C triangles at once (ceres_tpu.ops.intersect docstring). This
is a 2-level wide BVH with arity N_clusters — culling without divergence.

Per-triangle quantities stay differentiable w.r.t. the input soup; only the
*ordering* (argsort of morton codes) is detached.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp

from ceres_tpu.accel import morton
from ceres_tpu.models.mesh import TriangleSoup

# Triangles per cluster. Env-overridable (read once at import) for
# block-size sweeps; 128 is not yet tuned on the H100.
CLUSTER_SIZE = int(os.environ.get("CERES_CLUSTER_SIZE", 128))

# The megakernel's winner table carries the original triangle id as an f32
# VALUE (exact only in a 24-bit mantissa); guard the limit where the perm
# is built so an oversized soup fails loudly, not with rounded prim_ids.
_MAX_TRIANGLES = 1 << 24


def _check_soup_size(T: int) -> None:
    if T >= _MAX_TRIANGLES:
        raise ValueError(
            f"scene has {T} triangles; the megakernel carries triangle ids "
            f"as exact f32 values, which caps a soup at {_MAX_TRIANGLES - 1} "
            "triangles — split the scene (primitive sharding) instead")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Padded, morton-ordered triangle clusters.

    ``perm`` maps the packed slot (cluster * C + i) back to the original
    triangle id, with -1 marking padding slots (the Permuted=true
    pre-gathered layout of primitive_intersectors.hpp:17-20, taken to its
    conclusion: no indirection inside the hot loop at all). Padding
    triangles are all-zero records, which Möller-Trumbore rejects
    (det = 0 -> u = NaN -> NaN-safe accept is False, triangle.hpp:106-108).

    ``super_first``/``super_S`` (optional) carry the TREE-DERIVED super
    level for the megakernel's two-level walk: super j's member clusters
    are the contiguous fine ids [super_first[j], super_first[j+1]), at
    most ``super_S`` of them, and each super is a real LBVH node
    (lbvh.super_cut) — so its box (the union of its members' boxes,
    derived at search time) is tight, unlike unions of S consecutive
    blocks. ``super_first`` is padded with N_c past the real supers.
    Kept valid by refit (only boxes move; the cut is topology).
    """

    p0: jax.Array    # (N_c, C, 3)
    e1: jax.Array    # (N_c, C, 3)
    e2: jax.Array    # (N_c, C, 3)
    n: jax.Array     # (N_c, C, 3)
    lo: jax.Array    # (N_c, 3) cluster AABB min corners
    hi: jax.Array    # (N_c, 3) cluster AABB max corners
    perm: jax.Array  # (N_c * C,) int32, original triangle id or -1
    super_first: Optional[jax.Array] = None  # (N_s,) int32 first fine id
    super_S: int = dataclasses.field(
        default=0, metadata=dict(static=True))  # member slots per super

    @property
    def num_clusters(self) -> int:
        return self.p0.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.p0.shape[1]


def build_clusters(soup: TriangleSoup, cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """Sort triangles along the Morton curve and pack C-sized clusters.

    Fully jittable: the cluster count is static given the triangle count.
    Replaces the reference's builder stack (sort_primitives_by_morton_code,
    morton_code_based_builder.hpp:16-86 + the leaf layout the builders emit)
    with sort + gather + segmented min/max.
    """
    T = soup.num_triangles
    _check_soup_size(T)
    C = cluster_size
    num_clusters = -(-T // C)
    pad = num_clusters * C - T

    centers = (soup.p0 + soup.p1 + soup.p2) / 3.0
    order = morton.morton_order(centers)  # (T,) int32

    perm = jnp.concatenate([order, jnp.full((pad,), -1, jnp.int32)])
    gather_idx = jnp.concatenate([order, jnp.zeros((pad,), jnp.int32)])
    valid = perm >= 0  # (N_c * C,)

    def pack(x):
        g = x[gather_idx]
        g = jnp.where(valid[:, None], g, 0.0)
        return g.reshape(num_clusters, C, 3)

    p0 = pack(soup.p0)
    e1 = pack(soup.e1)
    e2 = pack(soup.e2)
    n = pack(soup.n)

    # Cluster AABBs from member-triangle AABBs; padding slots contribute
    # the empty box (+inf / -inf sentinels, bounding_box.hpp:64-70).
    p1 = p0 - e1
    p2 = p0 + e2
    pts = jnp.stack([p0, p1, p2], axis=2)  # (N_c, C, 3, 3)
    tri_lo = pts.min(axis=2)
    tri_hi = pts.max(axis=2)
    vmask = valid.reshape(num_clusters, C)[..., None]
    lo = jnp.where(vmask, tri_lo, jnp.inf).min(axis=1)
    hi = jnp.where(vmask, tri_hi, -jnp.inf).max(axis=1)

    return ClusterSet(p0=p0, e1=e1, e2=e2, n=n,
                      lo=jax.lax.stop_gradient(lo),
                      hi=jax.lax.stop_gradient(hi),
                      perm=perm)


def build_clusters_treelet(soup: TriangleSoup,
                           cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """LBVH-treelet clusters: same ClusterSet, much tighter AABBs.

    Fixed morton runs (``build_clusters``) slice the curve every C
    triangles regardless of geometry; here the runs come from the LBVH
    treelet cut (ceres_tpu.accel.lbvh.cluster_cut — the LeafCollapser
    analog): a cluster is a maximal subtree of <= C triangles, so its box
    is a real BVH node box. On bunny 1080p this halves scheduled kernel
    visits (11.3k -> 5.4k for the primary wavefront).

    Jittable with static shapes: the treelet count is data-dependent, so
    triangles scatter into a static ``2 * ceil(T / C)`` cluster budget;
    in the (rare) case the cut needs more clusters, falls back to the
    fixed morton runs inside the same budget (still correct, just looser).
    Empty padding clusters carry the empty box and are never visited.
    """
    from ceres_tpu.accel import lbvh as lbvh_mod

    T = soup.num_triangles
    _check_soup_size(T)
    C = cluster_size
    if T < 2 or T <= C:
        return build_clusters(soup, cluster_size)
    n_cap = 2 * (-(-T // C))

    bvh = lbvh_mod.build_lbvh(soup)
    starts, cluster_of = lbvh_mod.cluster_cut(bvh, C)
    n_t = jnp.sum(starts)

    # Fallback to fixed runs when the cut overflows the static budget or
    # any treelet... (cut treelets are <= C by construction; only the
    # count can overflow).
    pos = jnp.arange(T, dtype=jnp.int32)
    run_of = pos // C
    use_cut = n_t <= n_cap
    cluster_of = jnp.where(use_cut, cluster_of, run_of)

    # Slot within the cluster: position minus the cluster's first position.
    seg_start = jnp.where(use_cut,
                          jax.lax.cummax(jnp.where(
                              jnp.where(use_cut, starts, 0) > 0, pos, 0)),
                          run_of * C)
    within = pos - seg_start
    slot = cluster_of * C + within

    order = bvh.order  # sorted position -> original triangle id
    perm = jnp.full((n_cap * C,), -1, jnp.int32).at[slot].set(order)
    valid = perm >= 0

    def pack(x):
        g = jnp.zeros((n_cap * C, 3), x.dtype).at[slot].set(x[order])
        return g.reshape(n_cap, C, 3)

    p0 = pack(soup.p0)
    e1 = pack(soup.e1)
    e2 = pack(soup.e2)
    n = pack(soup.n)

    lo = jnp.full((n_cap, 3), jnp.inf).at[cluster_of].min(bvh.leaf_lo)
    hi = jnp.full((n_cap, 3), -jnp.inf).at[cluster_of].max(bvh.leaf_hi)
    del valid

    # Tree-derived SUPER level for the two-level walk: a second cut at
    # <= S fine clusters per super (lbvh.super_cut). Built here because
    # only the builder still holds the tree; stored as the (N_s,)
    # first-member table (boxes derive from the fine boxes at search
    # time, which keeps refit valid for free). Falls back to uniform
    # S-runs of fine ids (exactly the old consecutive-blocks supers)
    # when the fine cut itself fell back or the super cut overflows its
    # static budget.
    from ceres_tpu.ops.megakernel import _super_slots

    S = _super_slots(n_cap)
    n_s_cap = 2 * (-(-n_cap // S))
    starts2, super_of = lbvh_mod.super_cut(
        bvh, jnp.where(use_cut, starts, (pos % C == 0).astype(jnp.int32)),
        S)
    n_s = jnp.sum(starts2)
    use_super = use_cut & (n_s <= n_s_cap)
    # First sorted position of each super -> the fine id at it.
    sp = jnp.full((n_s_cap,), T, jnp.int32).at[
        jnp.where(starts2 == 1, super_of, n_s_cap)].min(pos, mode="drop")
    first_cut = jnp.where(sp < T, cluster_of[jnp.clip(sp, 0, T - 1)], n_cap)
    first_uniform = jnp.minimum(
        jnp.arange(n_s_cap, dtype=jnp.int32) * S, n_cap)
    super_first = jnp.where(use_super, first_cut, first_uniform)

    return ClusterSet(p0=p0, e1=e1, e2=e2, n=n,
                      lo=jax.lax.stop_gradient(lo),
                      hi=jax.lax.stop_gradient(hi),
                      perm=perm,
                      super_first=jax.lax.stop_gradient(super_first),
                      super_S=S)


def refit_clusters(clusters: ClusterSet, soup: TriangleSoup) -> ClusterSet:
    """Refit an existing cluster structure to MOVED vertices.

    The HierarchyRefitter capability (hierarchy_refitter.hpp:10-46) mapped
    to the flattened 2-level structure: the treelet CUT (``perm``) is kept
    from a previous build and only the per-triangle records and cluster
    AABBs are recomputed — one gather + one segmented min/max instead of
    the full LBVH build. The animation fast path for deforming geometry
    (the reference refits instead of rebuilding for the same reason);
    box quality degrades gracefully as the deformation grows, correctness
    never does (boxes stay exact bounds of their member triangles).
    Differentiable w.r.t. the new soup, like the builders.
    """
    perm = clusters.perm
    n_c, C = clusters.num_clusters, clusters.cluster_size
    gather_idx = jnp.clip(perm, 0)
    valid = perm >= 0

    def pack(x):
        g = jnp.where(valid[:, None], x[gather_idx], 0.0)
        return g.reshape(n_c, C, 3)

    p0 = pack(soup.p0)
    e1 = pack(soup.e1)
    e2 = pack(soup.e2)
    n = pack(soup.n)
    p1 = p0 - e1
    p2 = p0 + e2
    pts = jnp.stack([p0, p1, p2], axis=2)
    tri_lo = pts.min(axis=2)
    tri_hi = pts.max(axis=2)
    vmask = valid.reshape(n_c, C)[..., None]
    lo = jnp.where(vmask, tri_lo, jnp.inf).min(axis=1)
    hi = jnp.where(vmask, tri_hi, -jnp.inf).max(axis=1)
    # The super cut is pure topology: it survives a refit unchanged
    # (its boxes are derived from the refitted fine boxes at search
    # time).
    return ClusterSet(p0=p0, e1=e1, e2=e2, n=n,
                      lo=jax.lax.stop_gradient(lo),
                      hi=jax.lax.stop_gradient(hi),
                      perm=perm,
                      super_first=clusters.super_first,
                      super_S=clusters.super_S)


def _stack_packed_rows(rows, n_c, kp):
    """rows: list of K lists of 4 (N_c, C) channel planes -> (N_c, Kp, 4C).

    Every arithmetic input is an (N_c, C) plane, so building the packed
    weight tensor never touches an (N_c, C, 3) array. The only relayout
    is the final stack into the kernel's (N_c, Kp, 4C) slab layout
    (channel slabs side by side, K rows zero-padded to Kp) — the same
    bytes _pack_weights emits from the vector-shaped build.
    """
    packed = [jnp.concatenate(r, axis=-1) for r in rows]       # (N_c, 4C)
    w = jnp.stack(packed, axis=1)                              # (N_c, K, 4C)
    pad = kp - w.shape[1]
    if pad:
        w = jnp.pad(w, ((0, 0), (0, pad), (0, 0)))
    return w


def cluster_weights_common_origin_packed(clusters: ClusterSet,
                                         origin: jax.Array) -> jax.Array:
    """Packed-layout MT weights for common-origin rays: (N_c, 8, 4C).

    Same numbers as _pack_weights(cluster_weights_common_origin(...)),
    built entirely from (N_c, C) planes (see _stack_packed_rows).
    Feature rows: [d.x, d.y, d.z, 1]; channel slabs [u | v | det | t].
    """
    n_c, C = clusters.num_clusters, clusters.cluster_size
    p0 = [clusters.p0[:, :, a] - origin[a] for a in range(3)]
    e1 = [clusters.e1[:, :, a] for a in range(3)]
    e2 = [clusters.e2[:, :, a] for a in range(3)]
    n = [clusters.n[:, :, a] for a in range(3)]

    def cross(u, v):
        return [u[1] * v[2] - u[2] * v[1],
                u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0]]

    cu = cross(p0, e2)
    cv = cross(p0, e1)
    tn = n[0] * p0[0] + n[1] * p0[1] + n[2] * p0[2]
    z = jnp.zeros((n_c, C), clusters.p0.dtype)
    rows = [[cu[a], cv[a], n[a], z] for a in range(3)]
    rows.append([z, z, z, tn])
    return _stack_packed_rows(rows, n_c, 8)


def cluster_weights_generic_packed(clusters: ClusterSet,
                                   origin_shift: jax.Array) -> jax.Array:
    """Packed-layout MT weights for generic rays: (N_c, 16, 4C).

    Feature rows: [d, d x o, o, 1] (see cluster_weights_generic); built
    from (N_c, C) planes like the common-origin form.
    """
    n_c, C = clusters.num_clusters, clusters.cluster_size
    p0 = [clusters.p0[:, :, a] - origin_shift[a] for a in range(3)]
    e1 = [clusters.e1[:, :, a] for a in range(3)]
    e2 = [clusters.e2[:, :, a] for a in range(3)]
    n = [clusters.n[:, :, a] for a in range(3)]

    def cross(u, v):
        return [u[1] * v[2] - u[2] * v[1],
                u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0]]

    cu = cross(p0, e2)
    cv = cross(p0, e1)
    tn = n[0] * p0[0] + n[1] * p0[1] + n[2] * p0[2]
    z = jnp.zeros((n_c, C), clusters.p0.dtype)
    rows = [[cu[a], cv[a], n[a], z] for a in range(3)]          # d rows
    rows += [[-e2[a], -e1[a], z, z] for a in range(3)]          # d x o rows
    rows += [[z, z, z, -n[a]] for a in range(3)]                # o rows
    rows.append([z, z, z, tn])                                  # 1 row
    return _stack_packed_rows(rows, n_c, 16)


def cluster_weights_common_origin(clusters: ClusterSet, origin: jax.Array) -> jax.Array:
    """MT weight tensor for common-origin rays: (N_c, 4, C, 4) = (ch, tri, K).

    Channel order (0=u_num, 1=v_num, 2=det, 3=t_num) with feature layout
    [d, 1] (see ceres_tpu.ops.intersect.triangle_weights_common_origin; the
    layout here is transposed so the kernel's per-channel matmul is
    (C, K) @ (K, R) with C on the sublane axis).
    """
    p0 = clusters.p0 - origin
    e1, e2, n = clusters.e1, clusters.e2, clusters.n
    ones_shape = p0.shape[:-1] + (1,)
    zeros1 = jnp.zeros(ones_shape, p0.dtype)
    w_u = jnp.concatenate([jnp.cross(p0, e2), zeros1], axis=-1)   # (N_c, C, 4)
    w_v = jnp.concatenate([jnp.cross(p0, e1), zeros1], axis=-1)
    w_det = jnp.concatenate([n, zeros1], axis=-1)
    w_t = jnp.concatenate(
        [jnp.zeros_like(p0), jnp.sum(n * p0, axis=-1, keepdims=True)], axis=-1
    )
    return jnp.stack([w_u, w_v, w_det, w_t], axis=1)  # (N_c, 4, C, 4)


def cluster_weights_generic(clusters: ClusterSet, origin_shift: jax.Array) -> jax.Array:
    """MT weight tensor for generic-origin rays: (N_c, 4, C, 10).

    Feature layout [d, d x o, o, 1] with ray origins pre-shifted by
    ``origin_shift`` (see ceres_tpu.ops.intersect.triangle_weights).
    """
    p0 = clusters.p0 - origin_shift
    e1, e2, n = clusters.e1, clusters.e2, clusters.n
    zeros3 = jnp.zeros_like(p0)
    zeros1 = jnp.zeros(p0.shape[:-1] + (1,), p0.dtype)
    w_u = jnp.concatenate([jnp.cross(p0, e2), -e2, zeros3, zeros1], axis=-1)
    w_v = jnp.concatenate([jnp.cross(p0, e1), -e1, zeros3, zeros1], axis=-1)
    w_det = jnp.concatenate([n, zeros3, zeros3, zeros1], axis=-1)
    w_t = jnp.concatenate(
        [zeros3, zeros3, -n, jnp.sum(n * p0, axis=-1, keepdims=True)], axis=-1
    )
    return jnp.stack([w_u, w_v, w_det, w_t], axis=1)  # (N_c, 4, C, 10)
