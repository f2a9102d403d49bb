"""Treelet cuts of quality BVHs -> device ClusterSets.

The reference's whole point of builder choice is that its hot loop runs on
the tree the chosen builder emitted (static.cpp:106 BinnedSahBuilder,
anim.cpp:62 SweepSahBuilder). The walk kernel consumes ClusterSets
(ceres_tpu.accel.clusters), so this module turns ANY built tree — the
host golden builders' FlatBvh (SweepSAH / BinnedSAH / SBVH / reinsertion-
optimized) or the PLOC tree — into a ClusterSet via the same maximal-
subtree cut the LBVH path uses (lbvh.cluster_cut): a cluster is the
primitive set of a highest node with <= C primitives, its AABB the node's
REAL box. Cuts are host-side NumPy (the quality builders are host-side
precomputation, exactly like the reference's CPU build before render);
the resulting ClusterSet feeds the unchanged Pallas walk kernel.

Per-triangle records are gathered from ``soup`` with jnp ops, so the
ClusterSet stays differentiable w.r.t. vertices; only the structure
(perm, boxes) is detached — the same convention as build_clusters.
"""

from __future__ import annotations

from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from ceres_tpu.accel.clusters import CLUSTER_SIZE, ClusterSet
from ceres_tpu.accel.golden_builders import FlatBvh
from ceres_tpu.models.mesh import TriangleSoup


def _cut_flatbvh(bvh: FlatBvh, cluster_size: int, super_slots: int = 0):
    """Greedy maximal-subtree cut. Returns (prim id lists, lo, hi,
    super_first) — super_first is None unless ``super_slots`` > 0, in
    which case a SECOND maximal-subtree cut groups <= super_slots fine
    clusters per super (the megakernel two-level walk's upper level,
    here derived from the QUALITY tree's own interior nodes; the
    lbvh-path analog is lbvh.super_cut). Fine clusters are emitted
    super-by-super, so each super's members are contiguous fine ids."""
    prim_count = bvh.prim_count.astype(np.int64)
    first = bvh.first_child.astype(np.int64)
    counts = np.zeros(bvh.node_count, np.int64)
    gcount = np.zeros(bvh.node_count, np.int64)  # fine clusters in subtree

    # Subtree primitive + fine-cluster counts, iterative post-order.
    order = []
    stack = [0]
    while stack:
        i = stack.pop()
        order.append(i)
        if prim_count[i] == 0:
            stack.append(int(first[i]))
            stack.append(int(first[i]) + 1)
    for i in reversed(order):
        if prim_count[i] > 0:
            counts[i] = prim_count[i]
        else:
            counts[i] = counts[first[i]] + counts[first[i] + 1]
        gcount[i] = 1 if counts[i] <= cluster_size else (
            gcount[first[i]] + gcount[first[i] + 1]
            if prim_count[i] == 0 else 1)

    def subtree_prims(i: int) -> np.ndarray:
        out = []
        st = [i]
        while st:
            j = st.pop()
            if prim_count[j] > 0:
                out.append(
                    bvh.prim_indices[first[j]:first[j] + prim_count[j]])
            else:
                st.append(int(first[j]))
                st.append(int(first[j]) + 1)
        return np.concatenate(out)

    if super_slots == "auto":
        # Width matched to the search-time walk: the fine-cluster count
        # is gcount[0], known before any emission.
        from ceres_tpu.ops.megakernel import _super_slots

        super_slots = _super_slots(int(gcount[0]))

    groups: List[np.ndarray] = []
    los, his = [], []

    def emit_fine(i: int) -> None:
        st = [i]
        while st:
            j = st.pop()
            if counts[j] <= cluster_size:
                groups.append(subtree_prims(j))
                los.append(bvh.bounds[j, 0::2])
                his.append(bvh.bounds[j, 1::2])
            else:
                st.append(int(first[j]))
                st.append(int(first[j]) + 1)

    super_first = None
    if super_slots:
        super_first = []
        stack = [0]
        while stack:
            i = stack.pop()
            if gcount[i] <= super_slots:
                super_first.append(len(groups))
                emit_fine(i)
            else:
                stack.append(int(first[i]))
                stack.append(int(first[i]) + 1)
        super_first = np.asarray(super_first, np.int32)
    else:
        emit_fine(0)
    return (groups, np.asarray(los, np.float32),
            np.asarray(his, np.float32), super_first)


def _cut_ploc(tree, cluster_size: int):
    """Same cut on a PlocTree (children coded: negative = -(leaf_pos+1))."""
    left = np.asarray(tree.left)
    right = np.asarray(tree.right)
    order = np.asarray(tree.order)
    node_lo = np.asarray(tree.node_lo)
    node_hi = np.asarray(tree.node_hi)
    leaf_lo = np.asarray(tree.leaf_lo)
    leaf_hi = np.asarray(tree.leaf_hi)
    root = int(tree.root)
    n_int = left.shape[0]
    counts = np.zeros(n_int, np.int64)

    def kids(i):
        return int(left[i]), int(right[i])

    order_post = []
    stack = [root]
    while stack:
        i = stack.pop()
        order_post.append(i)
        for c in kids(i):
            if c >= 0:
                stack.append(c)
    for i in reversed(order_post):
        c = 0
        for ch in kids(i):
            c += 1 if ch < 0 else counts[ch]
        counts[i] = c

    def subtree_leaves(i: int) -> np.ndarray:
        out = []
        st = [i]
        while st:
            j = st.pop()
            for ch in kids(j):
                if ch < 0:
                    out.append(-(ch + 1))
                else:
                    st.append(ch)
        return order[np.asarray(out, np.int64)]

    groups, los, his = [], [], []
    stack = [root]
    while stack:
        i = stack.pop()
        if counts[i] <= cluster_size:
            groups.append(subtree_leaves(i))
            los.append(node_lo[i])
            his.append(node_hi[i])
        else:
            for ch in kids(i):
                if ch < 0:
                    pos = -(ch + 1)
                    groups.append(order[pos:pos + 1])
                    los.append(leaf_lo[pos])
                    his.append(leaf_hi[pos])
                else:
                    stack.append(ch)
    return (groups, np.asarray(los, np.float32), np.asarray(his, np.float32))


def _pack_clusterset(soup: TriangleSoup, groups, los, his,
                     cluster_size: int) -> ClusterSet:
    n_c = len(groups)
    C = cluster_size
    perm = np.full((n_c * C,), -1, np.int32)
    for k, g in enumerate(groups):
        assert g.shape[0] <= C, (k, g.shape)
        perm[k * C:k * C + g.shape[0]] = g
    perm_j = jnp.asarray(perm)
    gather = jnp.clip(perm_j, 0)
    valid = (perm_j >= 0)[:, None]

    def pack(x):
        g = jnp.where(valid, x[gather], 0.0)
        return g.reshape(n_c, C, 3)

    return ClusterSet(p0=pack(soup.p0), e1=pack(soup.e1), e2=pack(soup.e2),
                      n=pack(soup.n),
                      lo=jnp.asarray(los), hi=jnp.asarray(his), perm=perm_j)


def clusters_from_flatbvh(soup: TriangleSoup, bvh: FlatBvh,
                          cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """Cut a host FlatBvh (SweepSAH/BinnedSAH/SBVH/...) into a ClusterSet.

    Also derives the two-level walk's SUPER level from the same tree (a
    second maximal-subtree cut at <= megakernel._super_slots(n_c) fine
    clusters per super) so large scenes keep tree-tight super
    boxes with quality cuts too.

    NOTE: SBVH trees duplicate references (spatial splits); duplicates are
    fine — the walk kernel's closest-t winner is unaffected by seeing a
    triangle twice.
    """
    import dataclasses

    from ceres_tpu.ops.megakernel import _super_slots

    groups, los, his, super_first = _cut_flatbvh(bvh, cluster_size, "auto")
    cs = _pack_clusterset(soup, groups, los, his, cluster_size)
    return dataclasses.replace(cs, super_first=jnp.asarray(super_first),
                               super_S=_super_slots(len(groups)))


def clusters_from_ploc(soup: TriangleSoup, tree,
                       cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """Cut a PLOC tree (ceres_tpu.accel.ploc.build_ploc) into a ClusterSet."""
    groups, los, his = _cut_ploc(tree, cluster_size)
    return _pack_clusterset(soup, groups, los, his, cluster_size)


def build_clusters_quality(soup: TriangleSoup, builder: str = "sweep",
                           cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """One-call QUALITY ClusterSet for static-geometry frame loops.

    Quality cuts schedule fewer executed kernel visits than the default
    on-device LBVH treelet cut (the visit counts do not depend on the
    device; their H100 frame times are not measured yet). SweepSAH — the
    reference's own choice for its hot app (include/anim.cpp:62) — is
    the default here. The build is host-side NumPy (seconds; amortizes
    outside the frame loop exactly like the reference's pre-loop
    build); keep `build_clusters_treelet` for jittable in-graph builds
    (per-step rebuilds, deforming geometry, large scenes where the
    two-level walk uses the stored super cut).

    ``builder``: sweep | binned (native C++ when available) | sbvh |
    ploc | reinsert (SweepSAH + parallel reinsertion).
    """
    import jax

    soup_d = jax.tree.map(jax.lax.stop_gradient, soup)
    p0 = np.asarray(soup_d.p0)
    p1 = p0 - np.asarray(soup_d.e1)
    p2 = np.asarray(soup_d.e2) + p0
    pts = np.stack([p0, p1, p2], 1)
    lo, hi, centers = pts.min(1), pts.max(1), pts.mean(1)
    from ceres_tpu.accel import golden_builders as gb

    if builder == "sweep":
        bvh = gb.build_sweep_sah(lo, hi, centers)
    elif builder == "binned":
        from ceres_tpu.accel import native

        bvh = (native.build_binned_sah_fast(lo, hi, centers)
               if native.available()
               else gb.build_binned_sah(lo, hi, centers))
    elif builder == "sbvh":
        from ceres_tpu.accel.sbvh import build_sbvh

        bvh = build_sbvh(p0, p1, p2)
    elif builder == "ploc":
        from ceres_tpu.accel import ploc

        return clusters_from_ploc(soup, ploc.build_ploc(soup_d),
                                  cluster_size)
    elif builder == "reinsert":
        from ceres_tpu.accel.reinsertion import optimize_reinsertion

        bvh = optimize_reinsertion(gb.build_sweep_sah(lo, hi, centers))
    else:
        raise ValueError(f"unknown builder: {builder}")
    return clusters_from_flatbvh(soup, bvh, cluster_size)
