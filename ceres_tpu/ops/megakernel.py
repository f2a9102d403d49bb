"""Pallas ray-traversal megakernel: per-tile front-to-back cluster walk.

The replacement for the reference's per-ray BVH traversal hot loop
(lib/bvh/single_ray_traverser.hpp:67-126 + triangle.hpp:95-115), split
into two phases:

  1. **Interval culling prepass (pure JAX).** Rays arrive in spatially
     coherent 512-ray pixel-block tiles (ceres_tpu.utils.tiling). Each
     tile is summarized by interval hulls of its ray directions (and
     origins, for generic rays); every (tile, cluster) pair is culled
     with one conservative interval-arithmetic slab test — O(tiles x
     clusters) with NO ray dimension. Survivors are packed into ONE
     sortable int32 key per pair ((entry-bound bits | cluster id) — the
     f32 bit pattern is order-isomorphic to the float for values >= 0)
     and sorted FRONT TO BACK per tile with a single payload-free
     `jnp.sort` (the tile analog of descend-nearer-first,
     single_ray_traverser.hpp:95-113).
  2. **Walk kernel (Pallas, Triton route).** ONE program per ray tile: a
     while-loop walks that tile's sorted candidate list and EXITS as soon
     as the next entry bound exceeds the tile's prune — max over rays of
     min(closest-hit-so-far, scene-root exit) — i.e. the traverser's
     tmax-shrink pruning (single_ray_traverser.hpp:59,95-113) vectorized
     per tile, with the background-pixel worst case capped at the root
     exit. Each visit evaluates the R x C x 4 Möller-Trumbore numerators
     as f32 FMAs over the non-zero feature rows only, in chunks of
     _CHUNK_TRIS triangles so the (rays x chunk) block stays in
     registers, and reduces each chunk at once to one packed (t, slot)
     int32 key per ray (monotone bitcast; the low ceil(log2 C) mantissa
     bits carry the slot), so the per-visit selection is one row min.
     The accept is a branch-free sign test on exact f32 numerators (no
     tensor cores: TF32 would flip accepts at edges). All comparisons
     (t, tcap, entry, prune) stay in int-key space; the prune is padded
     +_PRUNE_PAD bits so the understated t keys never cause a
     non-conservative early exit. Weights, keys and tables are read from
     global memory by the program's own loads (the scene's working set
     is served by L2); scene size is bounded only by device memory.

Gradients flow with NO custom VJP: the kernel only *finds* winner ids
(integers, detached by construction — the standard differentiable-
rendering visibility convention), and (t, u, v) are recomputed at the R
winners by plain-JAX Möller-Trumbore (triangle.hpp:95-115), which JAX
differentiates w.r.t. triangle records, camera eye, and ray directions.
This also makes the prebuilt-``clusters`` fast lane fully differentiable:
the structure is only used for the detached search. The kernel's internal
t is therefore never observable outside winner selection; clearing its low
mantissa bits only affects tie-breaks among hits within 2^-16 relative.
"""

from __future__ import annotations

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ceres_tpu.accel import clusters as cl
from ceres_tpu.models.mesh import TriangleSoup
from ceres_tpu.ops.intersect import Hit

# Rays per culling tile (= one 16 x 32 pixel block) and per walk program.
# Env-overridable (read once at import) for sweeps.
TILE = int(os.environ.get("CERES_TILE", 512))
# Triangles per register block inside a cluster visit, and warps per
# walk program. Powers of two; the cluster width must be a multiple.
_CHUNK_TRIS = 4
_NUM_WARPS = 8

_BIG = 3.0e37      # "no hit yet" sentinel, finite to keep slab math NaN-free
_VALID_CUT = 1.0e37  # entries >= this are padding, never real candidates
_INV_CLAMP = 1e30
_ULP_PAD = 4e-6       # conservative slab widening (RobustNodeIntersector,
                      # node_intersectors.hpp:54-79: never cull a true hit)

# Above this many 128-triangle blocks the walk goes TWO-LEVEL: the dense
# culling prepass + sort runs over SUPERS of up to S member blocks, and
# the kernel gates each member block with an in-kernel interval test of
# the tile hull against the block's box (one vectorized slab test per
# super visit), then visits the passing members front to back by their
# FULL-precision entry bounds (an in-super priority walk). Supers come
# from the LBVH's OWN upper levels when available (ClusterSet.super_first
# — a second treelet cut at <= S fine clusters per super,
# lbvh.super_cut), so a super's box is a real tree-node box; the
# fallback groups S consecutive blocks. S grows with the scene so the
# prepass stays bounded at ~_SUPER_TARGET supers: the O(tiles x N_c)
# prepass and its key tensor become O(tiles x 1024) regardless of scene
# size. The flat walk's own limit is key quality: its packed keys clear
# ceil(log2 n_c) mantissa bits, so at ~14k blocks entries quantize to a
# ~2e-3 relative grid and boundary visits grow, while the priority walk
# gates members on full-precision entries. Where the two walks cross
# over on the H100 is not measured; the threshold is kept from the
# walk's first platform (CERES_HIER_MIN overrides it for probes).
_HIER_MIN_CLUSTERS = int(os.environ.get("CERES_HIER_MIN", 12288))
_SUPER_TARGET = 1024
_SUPER_MAX = 32   # gate bitmask lives in one int32


def _super_slots(n_c: int) -> int:
    """Member slots per super (8..32, keeping the super count near
    _SUPER_TARGET) — the size the builder's super cut must match."""
    s = 8
    while -(-n_c // s) > _SUPER_TARGET and s < _SUPER_MAX:
        s *= 2
    return s


def _super_factor(n_c: int) -> int:
    """Blocks per super: 1 = flat walk; else _super_slots."""
    if n_c <= _HIER_MIN_CLUSTERS:
        return 1
    return _super_slots(n_c)

# Prune-key slack, in int32 ulps of the f32 bit pattern (~3e-5
# relative). The walk's early exit is only conservative if the padded
# prune covers every way the carried t keys UNDERSTATE the true hit
# distances: the cleared low slot bits of the winner key (at most 127
# ulp for 128-triangle clusters) plus the error of the f32 divide that
# forms t (the Triton route emits div.full.f32, at most 2 ulp; the
# interpreter divides exactly) — 129 ulp in all, inside 256. Any new
# approximation in the winner t must fit in what is left, or widen this
# (wider pads cost extra boundary visits).
_PRUNE_PAD = 256

# "No hit" sentinel whose low mantissa bits are zero (survives the winner
# key's idx-bit clearing), and its int32 bit pattern.
_BIG_CLEAN_I = int(np.float32(_BIG).view(np.int32) & ~np.int32(127))
_BIG_CLEAN = float(np.int32(_BIG_CLEAN_I).view(np.float32))
_NEG_I = int(np.float32(-1.0).view(np.int32))  # bits of -1.0 (prune killer)
_IMAX = 0x7FFFFFFF


def _walk_interpret(platform: str | None = None) -> bool:
    """How the walk kernel runs on ``platform`` (default: JAX's backend).

    Compiled Triton on "gpu"; the Pallas interpreter on "cpu" (the test
    path). Any other platform has no route: the kernel never runs
    interpreted on an accelerator.
    """
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise ValueError(f"the walk kernel runs on 'gpu' (Triton) or 'cpu' "
                     f"(interpreted), not on {platform!r}")


def _safe_inverse(d):
    """Sign-preserving epsilon-clamped 1/d (reference vector.hpp:69-74)."""
    sign = jnp.where(d >= 0, 1.0, -1.0).astype(d.dtype)
    return jnp.where(jnp.abs(d) < 1e-30, sign * _INV_CLAMP, 1.0 / d)


# ---------------------------------------------------------------------------
# Phase 1: interval culling prepass (pure JAX)
# ---------------------------------------------------------------------------

def _interval_entry(lo, hi, dlo, dhi, olo=None, ohi=None):
    """Conservative slab test of a ray BUNDLE hull against cluster boxes.

    lo, hi: (N_c, 3) cluster AABBs. dlo/dhi (n_t, 3): per-tile direction
    interval hull; olo/ohi: origin hull (None = common origin at 0, boxes
    pre-shifted). Returns (n_t, N_c) f32: a LOWER bound of any member
    ray's slab entry distance where overlap is possible, +_BIG where NO
    member ray can overlap. Interval arithmetic over the corner products
    of (box - o) * (1/d); axes whose direction interval straddles zero are
    unrestrictive (their 1/d is not an interval). Conservative by
    construction — pruning in the kernel is against per-ray exact hit
    distances, so looseness only costs scheduled (skippable) visits.

    Every tensor op is (n_t, N_c)-shaped, with the xyz axis UNROLLED in
    Python (structure-of-arrays: no minor dimension of size 3). An
    origin hull folds into the box corners (box - [olo, ohi] is just a
    wider box), so generic rays cost the same 4 corner products per axis
    as common-origin rays.
    """
    empty = jnp.any(hi < lo, axis=-1)[None, :]       # (1, N_c) treelet pad
    tn = None
    tf = None
    for a in range(3):
        la = lo[None, :, a]                          # (1, N_c)
        ha = hi[None, :, a]
        if olo is not None:
            la = la - ohi[:, a : a + 1]              # (n_t, N_c)
            ha = ha - olo[:, a : a + 1]
        ia = _safe_inverse(dlo[:, a : a + 1])        # (n_t, 1)
        ib = _safe_inverse(dhi[:, a : a + 1])
        c0 = la * ia
        c1 = la * ib
        c2 = ha * ia
        c3 = ha * ib
        emin = jnp.minimum(jnp.minimum(c0, c1), jnp.minimum(c2, c3))
        emax = jnp.maximum(jnp.maximum(c0, c1), jnp.maximum(c2, c3))
        straddle = (dlo[:, a : a + 1] < 0) & (dhi[:, a : a + 1] > 0)
        emin = jnp.where(straddle, -_BIG, emin)
        emax = jnp.where(straddle, _BIG, emax)
        tn = emin if tn is None else jnp.maximum(tn, emin)
        tf = emax if tf is None else jnp.minimum(tf, emax)
    tn = jnp.maximum(tn, 0.0)
    hit = tn * (1.0 - _ULP_PAD) <= jnp.minimum(tf, _BIG) * (1.0 + _ULP_PAD)
    # Empty clusters (inf/-inf sentinel boxes from treelet padding) would
    # pass the inf-arithmetic test; mask them out explicitly.
    hit = hit & ~empty
    return jnp.where(hit, tn, _BIG)


def _hull(cols, alive):
    """3-tuple of (n_t, R) ray columns -> per-tile (lo, hi) hulls (n_t, 3).

    Axis-unrolled so every reduction is (n_t, R)-shaped (no minor
    dimension of size 3)."""
    los = []
    his = []
    for a in range(3):
        xa = cols[a]                                 # (n_t, R)
        los.append(jnp.where(alive, xa, _BIG).min(axis=1))
        his.append(jnp.where(alive, xa, -_BIG).max(axis=1))
    return jnp.stack(los, axis=-1), jnp.stack(his, axis=-1)


def _cid_bits(n_c: int) -> int:
    """Low-bit width reserved for a cluster id in a packed candidate key."""
    return max(1, (n_c - 1).bit_length())


def _tile_candidate_keys(lo, hi, dirs_tiled, origins_tiled=None, alive=None):
    """Per-tile candidate keys, sorted FRONT TO BACK, as ONE int32 array.

    dirs_tiled: 3-tuple of (n_tiles, R) direction columns (origins_tiled
    likewise). Each candidate is packed as (entry-bound f32 bits with the
    low cid_bits cleared) | cluster id — the bit pattern of a non-negative
    f32 is order-isomorphic to the float, so ONE payload-free `jnp.sort`
    orders candidates by entry bound (clearing low mantissa bits only
    LOWERS the bound: still a conservative lower bound of any member
    ray's hit distance). Returns (keys (n_tiles, N_c) int32 ascending,
    counts (n_tiles,) int32 of real candidates).
    """
    if alive is None:
        alive = (dirs_tiled[0] * dirs_tiled[0] + dirs_tiled[1] * dirs_tiled[1]
                 + dirs_tiled[2] * dirs_tiled[2]) > 0.0

    dlo, dhi = _hull(dirs_tiled, alive)
    if origins_tiled is None:
        tn = _interval_entry(lo, hi, dlo, dhi)
    else:
        olo, ohi = _hull(origins_tiled, alive)
        tn = _interval_entry(lo, hi, dlo, dhi, olo, ohi)
    # Tiles with no alive rays (all padding / all skipped) get nothing.
    tn = jnp.where(jnp.any(alive, axis=1)[:, None], tn, _BIG)
    counts = jnp.sum(tn < _VALID_CUT, axis=1).astype(jnp.int32)
    n_c = tn.shape[1]
    cmask = (1 << _cid_bits(n_c)) - 1
    cid = jax.lax.broadcasted_iota(jnp.int32, tn.shape, 1)
    keys = (jax.lax.bitcast_convert_type(tn, jnp.int32)
            & ~jnp.int32(cmask)) | cid
    return jnp.sort(keys, axis=1), counts


def _tile_cluster_lists(lo, hi, dirs_tiled, origins_tiled=None, alive=None):
    """Unpacked view of :func:`_tile_candidate_keys` (tests/profiling).

    Returns (lists (n_tiles, N_c) int32 candidate ids in ascending
    entry-bound order, entry (n_tiles, N_c) f32 bounds (low cid bits
    cleared; +_BIG past count), counts (n_tiles,) int32).
    """
    keys, counts = _tile_candidate_keys(lo, hi, dirs_tiled, origins_tiled,
                                        alive)
    cmask = jnp.int32((1 << _cid_bits(keys.shape[1])) - 1)
    lists = keys & cmask
    entry = jax.lax.bitcast_convert_type(keys & ~cmask, jnp.float32)
    return lists, entry, counts


def _super_members(lo, hi, first, S):
    """Super-level inputs from a per-super FIRST-member table.

    ``lo``/``hi`` are the (N_c, 3) fine block boxes ALREADY shifted into
    the kernel's frame; super j's members are the contiguous fine ids
    [first[j], first[j+1]) — at most S of them. ``first`` is either the
    tree-derived super cut (ClusterSet.super_first: real LBVH nodes,
    tight union boxes) or the uniform arange*S fallback (consecutive
    runs). Returns (super_lo, super_hi — the (n_s, 3) union boxes for
    the phase-1 prepass, empty-aware) and the (n_s, 8, S) member-box
    tensor the kernel gates with: rows 0-2 lo.xyz, 3-5 hi.xyz, 6 the
    empty flag, 7 pad. A super's union box equals the
    covering tree node's real box (the node box IS the union of its
    fine clusters' boxes).
    """
    n_c = lo.shape[0]
    n_s = first.shape[0]
    member = first[:, None] + jnp.arange(S, dtype=jnp.int32)[None, :]
    nxt = jnp.concatenate([first[1:], jnp.full((1,), n_c, jnp.int32)])
    valid = (member < nxt[:, None]) & (member < n_c)
    midx = jnp.clip(member, 0, n_c - 1)
    mlo = lo[midx]                                       # (n_s, S, 3)
    mhi = hi[midx]
    empty = jnp.any(mhi < mlo, axis=-1) | ~valid         # (n_s, S)
    lo_m = jnp.where(empty[..., None], _BIG, mlo)
    hi_m = jnp.where(empty[..., None], -_BIG, mhi)
    super_lo = lo_m.min(axis=1)
    super_hi = hi_m.max(axis=1)
    bbox = jnp.concatenate([
        jnp.transpose(mlo, (0, 2, 1)),
        jnp.transpose(mhi, (0, 2, 1)),
        empty[:, None, :].astype(lo.dtype),
        jnp.zeros((n_s, 1, S), lo.dtype)], axis=1)
    return super_lo, super_hi, bbox


def _tile_hulls(dirs_tiled, alive, origins_tiled=None):
    """(n_tiles, 16) per-tile hull scalars for the in-kernel block gate.

    Layout per tile: [1/dlo.xyz, 1/dhi.xyz, straddle.xyz, olo.xyz,
    ohi.xyz, pad] — the precomputed pieces of the _interval_entry test
    (safe inverses of the direction-interval ends and the zero-straddle
    flags), so the kernel's per-super gate is pure multiply/min/max on
    the S member boxes. Common-origin wavefronts (origins_tiled=None)
    get a zero origin hull: their boxes are pre-shifted.
    """
    dlo, dhi = _hull(dirs_tiled, alive)
    ia = _safe_inverse(dlo)
    ib = _safe_inverse(dhi)
    st = ((dlo < 0) & (dhi > 0)).astype(dlo.dtype)
    if origins_tiled is None:
        olo = jnp.zeros_like(dlo)
        ohi = jnp.zeros_like(dlo)
    else:
        olo, ohi = _hull(origins_tiled, alive)
    n_t = dlo.shape[0]
    return jnp.concatenate(
        [ia, ib, st, olo, ohi, jnp.zeros((n_t, 1), dlo.dtype)], axis=-1)


def _ray_tcap(root_lo, root_hi, origin_cols, dir_cols):
    """Per-ray visit cap: exit distance from the scene's root AABB.

    Every cluster box lies inside the root box, so a ray's slab entry to
    any cluster is <= its exit from the root. A ray that found no hit is
    therefore DONE once the walk passes its root exit — the fix for the
    background-pixel worst case (a miss ray no longer pins the tile's
    prune at +inf). Rays that miss the root entirely (or are padding) get
    a negative cap and never extend the walk. origin_cols=None means the
    common-origin wavefront with pre-shifted boxes.

    Rays come in COLUMN form (3 separate (R,) arrays): every op here is a
    flat (R,) vector op.
    """
    tn = None
    tf = None
    alive = None
    for a in range(3):
        d = dir_cols[a]
        inv = _safe_inverse(d)
        if origin_cols is None:
            t0 = root_lo[a] * inv
            t1 = root_hi[a] * inv
        else:
            t0 = (root_lo[a] - origin_cols[a]) * inv
            t1 = (root_hi[a] - origin_cols[a]) * inv
        near = jnp.minimum(t0, t1)
        far = jnp.maximum(t0, t1)
        tn = near if tn is None else jnp.maximum(tn, near)
        tf = far if tf is None else jnp.minimum(tf, far)
        sq = d * d
        alive = sq if alive is None else alive + sq
    tn = jnp.maximum(tn, 0.0)
    hit = (tn * (1.0 - _ULP_PAD) <= tf * (1.0 + _ULP_PAD)) & (alive > 0.0)
    return jnp.where(hit, tf * (1.0 + _ULP_PAD), -1.0)


# ---------------------------------------------------------------------------
# Phase 2: the walk kernel (Pallas, Triton route)
# ---------------------------------------------------------------------------

# Feature rows that carry non-zero weights in each numerator channel
# (u, v, det, t), keyed by the feature count K — the packed layouts of
# clusters.cluster_weights_common_origin_packed (rows [d, 1]) and
# cluster_weights_generic_packed (rows [d, d x o, o, 1]). The kernel
# forms only these products.
_MT_ROWS = {
    4: ((0, 1, 2), (0, 1, 2), (0, 1, 2), (3,)),
    10: ((0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5), (0, 1, 2), (6, 7, 8, 9)),
}


def _make_walk_kernel(c_size: int, n_c: int, R: int, K: int, mode: str,
                      S: int, window: bool, chunk: int):
    """One program per ray tile: walk the tile's sorted candidate list
    FRONT TO BACK, early-exiting on the tile prune (see module docstring).

    Closest mode carries per-ray (t-key, packed winner id) vectors;
    any-hit modes carry an occlusion flag vector. All prune comparisons
    happen on int32 f32-bit-patterns (order-isomorphic for values >= 0).
    Each program counts its executed block visits into its own slot of
    the ``steps`` output (programs run in no order, so nothing carries
    across them).

    ``S > 1`` is the TWO-LEVEL walk: each candidate is a SUPER of S
    blocks; ``n_c`` then counts supers. Per super visit the kernel
    interval-tests the tile hull (hull_ref scalars) against the S member
    block boxes (bbox_ref, one vectorized slab test) and then runs an
    in-super PRIORITY walk: it repeatedly extracts the unvisited member
    with the smallest full-precision entry bound (an int32 bitmask of
    unvisited slots) and visits it while that bound is under the live
    prune, so members are visited front to back and the prune converges
    as fast as in the flat walk.
    """
    rows = _MT_ROWS[K]
    used_rows = sorted(set(sum(rows, ())))
    ibits = max(1, (c_size - 1).bit_length())
    imask = (1 << ibits) - 1
    cmask = (1 << _cid_bits(n_c)) - 1
    n_chunks = c_size // chunk
    any_hit_mode = mode in ("any", "any_seg")
    hier = S > 1

    def kernel(*refs):
        refs = list(refs)
        cnt_ref = refs.pop(0)
        key_ref = refs.pop(0)
        f_ref = refs.pop(0)
        occ0_ref = refs.pop(0) if any_hit_mode else None
        hull_ref = refs.pop(0) if hier else None
        bbox_ref = refs.pop(0) if hier else None
        first_ref = refs.pop(0) if hier else None
        w_ref = refs.pop(0)
        out_ref = refs.pop(0)
        steps_ref = refs.pop(0)
        i = pl.program_id(0)
        count = cnt_ref[i]

        # Feature block is CHANNEL-FIRST (Kp, n_tiles * R): one contiguous
        # (R,) row per feature. The root-exit cap rides row K; as int bits
        # it joins the key-space comparisons directly. Dead rays carry
        # tcap = -1.0 (negative bits) and never extend the prune.
        rays = pl.ds(i * R, R)
        feats = {k: f_ref[k, rays] for k in used_rows}
        tcap_i = jax.lax.bitcast_convert_type(f_ref[K, rays], jnp.int32)
        if window:
            # Per-ray [tmin, tmax] accept window (bvh::Ray semantics,
            # ray.hpp:9-23) on the next two rows.
            tmin_f = f_ref[K + 1, rays][:, None]
            tmax_f = f_ref[K + 2, rays][:, None]
        slot = jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)

        def numerators(bid, j):
            """(R, chunk) u/v/det/t numerators of triangles
            [j * chunk, (j + 1) * chunk) of block ``bid`` — f32 FMAs over
            the non-zero rows of the packed weights."""
            out = []
            for ch in range(4):
                cols = pl.ds(ch * c_size + j * chunk, chunk)
                acc = None
                for k in rows[ch]:
                    term = feats[k][:, None] * w_ref[bid, k, cols][None, :]
                    acc = term if acc is None else acc + term
                out.append(acc)
            return out

        def accept(nu, nv, nd, nt):
            """Branch-free Möller-Trumbore sign test on the numerators."""
            s = jnp.where(nd >= 0, jnp.float32(1), jnp.float32(-1))
            uvw = jnp.minimum(jnp.minimum(nu * s, nv * s),
                              (nd - nu - nv) * s)
            ok = (jnp.minimum(uvw, nt * s) >= 0) & (nd != 0)     # t >= 0
            if mode == "any_seg":
                # Segment rays (t = 1 at the segment's far end): only
                # occluders at t <= 1 count.
                ok = ok & ((nt - nd) * s <= 0)
            return ok

        def visit_closest(bid, carry):
            """Winner update of every ray against block ``bid``."""
            def chunk_body(j, carry):
                t_i, pid = carry
                nu, nv, nd, nt = numerators(bid, j)
                ok = accept(nu, nv, nd, nt)
                # t only feeds winner SELECTION (t/u/v are recomputed at
                # the winners in plain JAX); nd == 0 lanes give inf/NaN,
                # which ok (requiring nd != 0) masks to _BIG_CLEAN.
                t = jnp.where(ok, nt / nd, _BIG_CLEAN)
                if window:
                    t = jnp.where((t >= tmin_f) & (t <= tmax_f), t,
                                  _BIG_CLEAN)
                keys = ((jax.lax.bitcast_convert_type(t, jnp.int32)
                         & ~imask) | (slot + j * chunk))
                kmin = jnp.min(keys, axis=1)
                t_new = kmin & ~imask
                better = t_new < t_i
                t_i = jnp.where(better, t_new, t_i)
                pid = jnp.where(better, bid * c_size + (kmin & imask), pid)
                return t_i, pid

            return jax.lax.fori_loop(0, n_chunks, chunk_body, carry)

        def visit_any(bid, occ):
            def chunk_body(j, occ):
                ok = accept(*numerators(bid, j))
                return occ | jnp.max(
                    jnp.where(ok, jnp.int32(1), jnp.int32(0)), axis=1)

            return jax.lax.fori_loop(0, n_chunks, chunk_body, occ)

        if any_hit_mode:
            visit = visit_any
            carry0 = occ0_ref[...]

            def prune_of(occ):
                return (jnp.max(jnp.where(occ > 0, _NEG_I, tcap_i))
                        + _PRUNE_PAD)
        else:
            visit = visit_closest
            carry0 = (jnp.full((R,), _BIG_CLEAN_I, jnp.int32),
                      jnp.full((R,), -1, jnp.int32))

            def prune_of(carry):
                return jnp.max(jnp.minimum(carry[0], tcap_i)) + _PRUNE_PAD

        def cond(state):
            k, prune_i = state[0], state[1]
            # Compare the PURE entry bound: mask the low cid bits before
            # the prune test. They raise the key by up to 2^cid_bits - 1
            # ulps, which EXCEEDS _PRUNE_PAD once n_c > 256 — testing the
            # full key would non-conservatively end the walk while a
            # remaining candidate can still hold a closer hit.
            key_k = key_ref[i, jnp.minimum(k, n_c - 1)]
            return (k < count) & ((key_k & ~cmask) <= prune_i)

        if hier:
            # Per-tile hull scalars (precomputed in phase 1): safe inverses
            # of the direction-interval ends, straddle flags, and the
            # origin hull (zeros for common-origin wavefronts whose boxes
            # are pre-shifted).
            ia = [hull_ref[i, a] for a in range(3)]
            ib = [hull_ref[i, 3 + a] for a in range(3)]
            sf = [hull_ref[i, 6 + a] for a in range(3)]
            olo = [hull_ref[i, 9 + a] for a in range(3)]
            ohi = [hull_ref[i, 12 + a] for a in range(3)]
            bitlane = jax.lax.broadcasted_iota(jnp.int32, (S,), 0)
            rem0 = jnp.int32(-1) if S == 32 else jnp.int32((1 << S) - 1)

            def block_entries(sid):
                """Int-key entry bounds (S,) of the tile hull against the
                member block boxes of super ``sid`` — the _interval_entry
                test, vectorized over the S members."""
                tn = None
                tf = None
                for a in range(3):
                    la = bbox_ref[sid, a, :] - ohi[a]
                    ha = bbox_ref[sid, 3 + a, :] - olo[a]
                    c0 = la * ia[a]
                    c1 = la * ib[a]
                    c2 = ha * ia[a]
                    c3 = ha * ib[a]
                    emin = jnp.minimum(jnp.minimum(c0, c1),
                                       jnp.minimum(c2, c3))
                    emax = jnp.maximum(jnp.maximum(c0, c1),
                                       jnp.maximum(c2, c3))
                    wide = sf[a] > 0
                    emin = jnp.where(wide, -_BIG, emin)
                    emax = jnp.where(wide, _BIG, emax)
                    tn = emin if tn is None else jnp.maximum(tn, emin)
                    tf = emax if tf is None else jnp.minimum(tf, emax)
                tn = jnp.maximum(tn, 0.0)
                okb = (tn * (1.0 - _ULP_PAD)
                       <= jnp.minimum(tf, _BIG) * (1.0 + _ULP_PAD))
                okb = okb & (bbox_ref[sid, 6, :] == 0.0)
                return jax.lax.bitcast_convert_type(
                    jnp.where(okb, tn, _BIG), jnp.int32)

            def body(state):
                k, prune_i, carry, nvis = state
                sid = key_ref[i, k] & cmask
                fs = first_ref[sid]
                ent = block_entries(sid)

                def in_cond(st2):
                    live = ((st2[0] >> bitlane) & 1) == 1
                    return jnp.min(jnp.where(live, ent, _IMAX)) <= st2[3]

                def in_body(st2):
                    rem, carry, nv, _ = st2
                    live = ((rem >> bitlane) & 1) == 1
                    masked = jnp.where(live, ent, _IMAX)
                    m = jnp.min(masked)
                    s = jnp.min(jnp.where(masked == m, bitlane, _IMAX))
                    rem = rem & ~(jnp.int32(1) << s)
                    carry = visit(fs + s, carry)
                    return rem, carry, nv + 1, prune_of(carry)

                _, carry, nvis, prune_i = jax.lax.while_loop(
                    in_cond, in_body, (rem0, carry, nvis, prune_i))
                return k + 1, prune_i, carry, nvis
        else:
            def body(state):
                k, _, carry, nvis = state
                carry = visit(key_ref[i, k] & cmask, carry)
                return k + 1, prune_of(carry), carry, nvis + 1

        _, _, carry, nvis = jax.lax.while_loop(
            cond, body, (jnp.int32(0), prune_of(carry0), carry0,
                         jnp.int32(0)))
        out_ref[...] = carry if any_hit_mode else carry[1]
        steps_ref[i] = nvis

    return kernel


@functools.partial(jax.jit, static_argnames=("K", "mode", "interpret", "S",
                                             "window", "chunk"))
def _walk_pallas(counts, keys, feats, w, occ0=None, hull=None, bbox=None,
                 first=None, *, K, mode, interpret, S=1, window=False,
                 chunk=None):
    """Launch the walk kernel, one program per tile. Returns (out, steps).

    feats is CHANNEL-FIRST (Kp, n_tiles * R): rows [features (K), tcap,
    window rows...]. occ0, when given, is flat (n_tiles * R,). out is
    flat (n_tiles * R,) int32 — packed winner slot ids (closest mode,
    -1 = miss) or occlusion flags (any-hit modes). steps is the
    (n_tiles,) MEASURED executed block visits of each tile (the
    Statistics capability, single_ray_traverser.hpp:131-163); callers
    sum it.

    ``S > 1`` selects the two-level walk: ``keys``/``counts`` are then
    per-SUPER (n_tiles, n_s) candidates, ``w`` holds the fine blocks
    (zero-padded by S), ``hull`` is the (n_tiles, 16) per-tile
    hull-scalar table, ``bbox`` the (n_s, 8, S) member-block box tensor
    and ``first`` the (n_s,) first-member table (member block m of
    super j is fine block first[j] + m).

    ``chunk`` is the triangles per register block (default _CHUNK_TRIS
    compiled, the whole cluster interpreted — the CPU interpreter has no
    registers to spare and runs fewer, wider steps faster).
    """
    _, R_total = feats.shape
    n_tiles = counts.shape[0]
    R = R_total // n_tiles
    c_size = w.shape[-1] // 4
    n_c = bbox.shape[0] if S > 1 else w.shape[0]
    if chunk is None:
        chunk = c_size if interpret else min(_CHUNK_TRIS, c_size)
    if c_size % chunk:
        raise ValueError(f"chunk {chunk} must divide the cluster width "
                         f"{c_size}")
    whole = pl.BlockSpec(memory_space=pl.ANY)
    tile_rays = pl.BlockSpec((R,), lambda i: (i,))
    in_specs = [whole, whole, whole]
    args = [counts, keys, feats]
    if mode in ("any", "any_seg"):
        in_specs.append(tile_rays)
        args.append(occ0)
    if S > 1:
        in_specs += [whole, whole, whole]
        args += [hull, bbox, first]
    in_specs.append(whole)
    args.append(w)
    out, steps = pl.pallas_call(
        _make_walk_kernel(c_size, n_c, R, K, mode, S, window, chunk),
        grid=(n_tiles,),
        in_specs=in_specs,
        out_specs=[tile_rays, whole],
        out_shape=[jax.ShapeDtypeStruct((R_total,), jnp.int32),
                   jax.ShapeDtypeStruct((n_tiles,), jnp.int32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="ceres_walk",
    )(*args)
    return out, steps


# ---------------------------------------------------------------------------
# Packing helpers
# ---------------------------------------------------------------------------

def _pack_weights(w):
    """(N_c, 4, C, K) -> (N_c, Kp, 4 * C): the lane-slab layout.

    Channels go side by side along the lane axis so one step's numerators
    come out as [u_num | v_num | det | t_num] slabs; K is zero-padded to a
    sublane multiple (the padded feature entries are zero too, so the
    contraction is unchanged).
    """
    n_c, ch, C, K = w.shape
    w = jnp.transpose(w, (0, 3, 1, 2)).reshape(n_c, K, ch * C)
    pad = (-K) % 8
    if pad:
        w = jnp.pad(w, ((0, 0), (0, pad), (0, 0)))
    return w


def _cols(x):
    """(R, 3) array or 3-tuple of (R,) columns -> 3-tuple of columns.

    The public entry points accept either form; everything internal runs
    on flat (R,) columns (structure-of-arrays).
    """
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x[..., 0], x[..., 1], x[..., 2])


def _feats_from_cols(cols, kp, tcap=None, extra=()):
    """Per-ray feature columns -> CHANNEL-FIRST (kp, R).

    Layout: rows [cols..., 1, tcap?, extra..., zeros...], one contiguous
    (R,) row per feature. The root-exit cap rides the first spare
    (zero-weight-row) feature row, saving the kernel a separate input
    stream; its row index is ``len(cols) + 1`` (returned layout is
    static per n_feat). ``extra`` rows (e.g. the per-ray tmin/tmax
    window) follow the tcap row on further spare zero-weight rows.
    """
    R = cols[0].shape[0]
    arrs = list(cols) + [jnp.ones((R,), cols[0].dtype)]
    if tcap is not None:
        arrs.append(tcap)
    arrs.extend(extra)
    if len(arrs) > kp:
        raise ValueError(f"{len(arrs)} feature rows exceed kp={kp}")
    if kp > len(arrs):
        zero = jnp.zeros((R,), cols[0].dtype)
        arrs.extend([zero] * (kp - len(arrs)))
    return jnp.stack([a.astype(cols[0].dtype) for a in arrs], axis=0)


def _pad_rays(x, tile=TILE):
    """(R, ...) -> (R_pad, ...) zero-padded to a multiple of ``tile``."""
    pad = (-x.shape[0]) % tile
    if pad:
        x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
    return x


def _tile_rays(x, tile):
    """(R, ...) -> (n_tiles, tile, ...) zero-padded."""
    x = _pad_rays(x, tile)
    return x.reshape((-1, tile) + x.shape[1:])


def _scene_root(cs):
    """Root AABB over the non-empty cluster boxes."""
    nonempty = jnp.all(cs.hi >= cs.lo, axis=-1, keepdims=True)
    root_lo = jnp.where(nonempty, cs.lo, _BIG).min(axis=0)
    root_hi = jnp.where(nonempty, cs.hi, -_BIG).max(axis=0)
    return root_lo, root_hi


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _detach_f32(tree):
    """stop_gradient + cast floating leaves to f32: the SEARCH precision.

    The kernel's double-precision story (the reference's ``Scalar``
    float/double axis, anim.cpp:154-158): winner/occlusion SEARCH always
    runs the f32 walk kernel; everything a float64 caller observes —
    (t, u, v) at the winners, shading, gradients — is recomputed in f64
    from the original arrays. The deviation from an all-f64 traversal is
    confined to winner tie-breaks within f32 resolution, the same class
    (and source) of deviation as the kernel's cleared-mantissa t keys.
    """
    def leaf(x):
        x = jax.lax.stop_gradient(x)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating):
            return jnp.asarray(x, jnp.float32)
        return x
    return jax.tree.map(leaf, tree)


def _hier_setup(lo, hi, dirs_tiled, alive, origins_tiled, w, cs=None):
    """Choose flat vs two-level walk and build the super-level inputs.

    Returns (S, hull, bbox, first, cull_lo, cull_hi, w): for S == 1 the
    inputs pass through untouched (flat walk); for S > 1 the phase-1
    culling boxes become the super unions, ``w`` is zero-padded by S
    blocks (the kernel reads members as first + s), and the kernel gets
    the per-tile hull table + member-box tensor + first-member table
    for in-kernel block gating. The super level comes from the
    ClusterSet's tree-derived cut when present (``cs.super_first``,
    real LBVH nodes); otherwise uniform S-runs of consecutive blocks.
    """
    n_c = lo.shape[0]
    if n_c <= _HIER_MIN_CLUSTERS:
        return 1, None, None, None, lo, hi, w
    if cs is not None and cs.super_first is not None and cs.super_S > 1:
        S = cs.super_S
        first = cs.super_first
    else:
        S = _super_slots(n_c)
        n_s = -(-n_c // S)
        first = jnp.minimum(jnp.arange(n_s, dtype=jnp.int32) * S, n_c)
    super_lo, super_hi, bbox = _super_members(lo, hi, first, S)
    hull = _tile_hulls(dirs_tiled, alive, origins_tiled)
    # Member reads run to first + S - 1 <= n_c + S - 1: zero-pad the
    # weight blocks (zero records are MT-rejected; gated off anyway).
    w = jnp.pad(w, ((0, S), (0, 0), (0, 0)))
    return S, hull, bbox, first, super_lo, super_hi, w


def _closest_search(cs, eye, dir_cols, tmin=None, tmax=None):
    """Detached winner search: packed slot ids + counters (no gradients).

    Always f32 (see _detach_f32) — float64 callers get f64 values from
    the plain-JAX recompute at the winners, not from the kernel.
    ``tmin``/``tmax`` (scalar or per-ray) restrict accepts to the
    bvh::Ray window [tmin, tmax] (ray.hpp:9-23); tmax additionally caps
    the walk (nothing past it needs visiting).
    """
    cs, eye, dir_cols, tmin, tmax = _detach_f32(
        (cs, eye, dir_cols, tmin, tmax))
    window = tmin is not None or tmax is not None
    R = dir_cols[0].shape[0]
    w = cl.cluster_weights_common_origin_packed(cs, eye)
    lo = cs.lo - eye
    hi = cs.hi - eye
    root_lo, root_hi = _scene_root(cs)
    dp = tuple(_pad_rays(c) for c in dir_cols)
    dirs_tiled = tuple(c.reshape(-1, TILE) for c in dp)
    alive = (dirs_tiled[0] * dirs_tiled[0] + dirs_tiled[1] * dirs_tiled[1]
             + dirs_tiled[2] * dirs_tiled[2]) > 0.0
    tcap = _ray_tcap(root_lo - eye, root_hi - eye, None, dp)
    extra = ()
    if window:
        tmin_a = (jnp.zeros((R,), jnp.float32) if tmin is None
                  else jnp.broadcast_to(jnp.asarray(tmin, jnp.float32),
                                        (R,)))
        tmax_a = (jnp.full((R,), _BIG, jnp.float32) if tmax is None
                  else jnp.broadcast_to(jnp.asarray(tmax, jnp.float32),
                                        (R,)))
        tmin_p = _pad_rays(tmin_a)
        tmax_p = _pad_rays(tmax_a)
        # Walk cap: no candidate past tmax can matter (padded
        # conservatively like the root exit). Dead rays keep tcap -1.
        tcap = jnp.where(tcap < 0, tcap,
                         jnp.minimum(tcap, tmax_p * (1.0 + _ULP_PAD)))
        extra = (tmin_p, tmax_p)
    feats = _feats_from_cols(dp, w.shape[1], tcap=tcap, extra=extra)
    S, hull, bbox, first, cull_lo, cull_hi, w = _hier_setup(
        lo, hi, dirs_tiled, alive, None, w, cs=cs)
    keys, counts = _tile_candidate_keys(cull_lo, cull_hi, dirs_tiled,
                                        alive=alive)
    pidx, steps = _walk_pallas(
        counts, keys, feats, w, hull=hull, bbox=bbox, first=first,
        K=4, mode="closest", interpret=_walk_interpret(), S=S,
        window=window)
    steps = jnp.sum(steps)
    return pidx.reshape(-1)[:R], {"traversal_steps": steps,
                                  "mt_block_visits": steps}


def _winner_tuv(rec, eye, dir_cols):
    """Reference Möller-Trumbore at (ray, winning triangle) pairs.

    Exactly triangle.hpp:95-115 with c = p0 - eye, evaluated only at the R
    winners instead of through the R x T search — this is where gradients
    of (t, u, v) w.r.t. vertices / camera / ray directions come from.
    ``rec`` is the sequence of gathered winner-table COLUMNS
    [p0 x3, e1 x3, e2 x3, ...]; all math is column (R,) ops. The face
    normal is RECOMPUTED as cross(e1, e2) — bit-identical to the stored
    soup.n (mesh.py builds it with the same formula) and 9 column ops
    beat gathering three more 8 MB winner columns per frame.
    """
    p0 = (rec[0], rec[1], rec[2])
    e1 = (rec[3], rec[4], rec[5])
    e2 = (rec[6], rec[7], rec[8])
    n = (e1[1] * e2[2] - e1[2] * e2[1],
         e1[2] * e2[0] - e1[0] * e2[2],
         e1[0] * e2[1] - e1[1] * e2[0])
    d = dir_cols
    c = tuple(p0[a] - eye[a] for a in range(3))
    r = (d[1] * c[2] - d[2] * c[1],
         d[2] * c[0] - d[0] * c[2],
         d[0] * c[1] - d[1] * c[0])
    det = n[0] * d[0] + n[1] * d[1] + n[2] * d[2]
    # det == 0 can only occur at non-winner (masked) rays — the kernel's
    # accept requires det != 0 — but an unprotected 1/0 there would poison
    # gradients through the final jnp.where (0 cotangent x inf partial).
    inv = 1.0 / jnp.where(det != 0, det, 1.0)
    u = (r[0] * e2[0] + r[1] * e2[1] + r[2] * e2[2]) * inv
    v = (r[0] * e1[0] + r[1] * e1[1] + r[2] * e1[2]) * inv
    t = (n[0] * c[0] + n[1] * c[1] + n[2] * c[2]) * inv
    return t, u, v


def _winner_table_cols(soup: TriangleSoup, cs, payload_cols):
    """List of (N_c * C,) winner-table COLUMNS in cluster-slot order.

    Column layout: [p0 x3, e1 x3, e2 x3, perm, payload...] of
    the triangle stored at each slot, so per-column gathers by the
    kernel's packed winner id serve the differentiable (t, u, v)
    recompute, the original triangle id (perm as an exact f32 VALUE — ids
    are exact in a float32 mantissa up to 2^24 triangles, and a float
    value survives the dense-unpack matmul where a bit pattern would be
    denormal-flushed), and any per-triangle shading payload. The face
    normal is NOT stored — _winner_tuv recomputes it as cross(e1, e2)
    (bit-identical; three fewer gathered columns per frame). Built from
    ``soup`` (NOT the stop-gradiented cluster arrays) so gradients flow
    to vertices through the gather.
    """
    src = jnp.clip(cs.perm, 0)
    valid = cs.perm >= 0
    cols = []
    for arr in (soup.p0, soup.e1, soup.e2):
        for a in range(3):
            cols.append(jnp.where(valid, arr[src, a], 0.0))
    cols.append(cs.perm.astype(jnp.float32))
    for c in payload_cols or ():
        cols.append(jnp.where(valid, c[src], 0.0))
    return cols


def winner_table(soup: TriangleSoup, clusters, payload=None):
    """Precompute the STACKED winner table for a static-geometry loop.

    The table depends only on (soup, clusters, payload) — loop-invariant
    across frames of static geometry. XLA may hoist its construction out
    of a jitted frame loop itself; this serves EAGER per-frame callers
    and makes the hoist explicit. Pass back via ``closest_hit_common_origin(..., table_cols=...)``;
    the payload must be the same sequence that call would receive.
    Differentiable w.r.t. ``soup`` exactly like the inline build.
    """
    return jnp.stack(_winner_table_cols(soup, clusters, payload), axis=-1)


def closest_hit_common_origin(soup: TriangleSoup, eye, dirs, clusters=None,
                              with_counts=False, payload=None,
                              tmin=None, tmax=None, normal_cols=False,
                              exact_f64=False, table_cols=None):
    """Closest hit of normalized ``dirs`` rays all starting at ``eye``.

    ``dirs`` is (R, 3) or a 3-tuple of (R,) columns (the fast form — all
    internal math is structure-of-arrays). With ``clusters`` (a prebuilt
    ClusterSet for this exact soup) the acceleration-structure build is
    skipped — the fast lane for frame loops over static geometry. Fully
    differentiable either way: the structure only drives the detached
    winner search; (t, u, v) come from a plain-JAX Möller-Trumbore
    recomputation at the winners, gathered from ``soup`` by original
    triangle id.

    ``tmin``/``tmax`` (scalar or per-ray (R,)) restrict accepted hits to
    the bvh::Ray window tmin <= t <= tmax (ray.hpp:9-23; default the
    unbounded [0, +big) the reference constructs). tmax also caps the
    walk, like the closest-hit tmax shrink (single_ray_traverser.hpp:59).

    ``payload`` (a sequence of P per-triangle (T,) columns, e.g. shading
    normals) rides the winner gather: returns (hit, payload_cols — a
    P-tuple of (R,) columns) with zeros at misses. ``normal_cols=True``
    PREPENDS the winner's face-normal columns (3) to the returned
    payload — recomputed as cross(e1, e2) from the already-gathered
    edge columns, bit-identical to gathering soup.n and three 8 MB
    winner columns cheaper per frame. ``with_counts=True``
    additionally returns the traversal
    counters (MEASURED walk-loop cluster visits — early exits included,
    so steps == executed MT blocks) — the SingleRayTraverser::Statistics
    capability (single_ray_traverser.hpp:131-163), measured, not
    scheduled.
    """
    dir_cols = _cols(dirs)
    cs = clusters
    if cs is None:
        cs = cl.build_clusters_treelet(
            jax.tree.map(jax.lax.stop_gradient, soup))
    if exact_f64:
        # ALL-f64 traversal (the reference's Scalar=double searched in
        # double everywhere): the plain-JAX cluster walk instead of the
        # f32 Pallas datapath. Same structure, same recompute epilogue.
        if jnp.asarray(soup.p0).dtype != jnp.float64:
            raise ValueError("exact_f64 requires a float64 soup "
                             "(enable jax_enable_x64)")
        from ceres_tpu.ops import walk_f64

        pidx, counts = walk_f64.closest_search_f64(
            cs, jnp.asarray(eye), dir_cols, tmin=tmin, tmax=tmax)
    else:
        pidx, counts = _closest_search(cs, eye, dir_cols, tmin=tmin,
                                       tmax=tmax)
    mask = pidx >= 0
    table = (table_cols if table_cols is not None
             else jnp.stack(_winner_table_cols(soup, cs, payload),
                            axis=-1))
    n_cols = table.shape[-1]
    idx = jnp.clip(pidx, 0)
    # ONE row gather, then an identity matmul to materialize the columns
    # as dense rows: a plain transpose can become a layout bitcast that
    # leaves every column consumer reading the strided gather output.
    # Whether this layout still pays on the H100 is not measured. Exact
    # (identity rows at HIGHEST precision: true f32) and linear, so
    # gradients pass through untouched.
    recT = jnp.matmul(jnp.eye(n_cols, dtype=table.dtype),
                      jnp.transpose(table[idx]),
                      precision=jax.lax.Precision.HIGHEST)
    rec = tuple(recT)
    prim = jnp.where(mask, rec[9].astype(jnp.int32), 0)
    t, u, v = _winner_tuv(rec, eye, dir_cols)
    hit = Hit(t=jnp.where(mask, t, jnp.inf),
              u=jnp.where(mask, u, 0.0),
              v=jnp.where(mask, v, 0.0),
              prim_id=prim, mask=mask)
    out_pay = tuple(rec[10:])
    if normal_cols:
        e1c, e2c = rec[3:6], rec[6:9]
        out_pay = (e1c[1] * e2c[2] - e1c[2] * e2c[1],
                   e1c[2] * e2c[0] - e1c[0] * e2c[2],
                   e1c[0] * e2c[1] - e1c[1] * e2c[0]) + out_pay
    out = ((hit,) if payload is None and not normal_cols
           else (hit, out_pay))
    if with_counts:
        counts["mt_pairs"] = (counts["mt_block_visits"]
                              * TILE * cs.cluster_size)
        out = out + (counts,)
    return out[0] if len(out) == 1 else out


def any_hit(soup: TriangleSoup, origin_shift, origins, dirs, skip=None,
            clusters=None, with_counts=False, exact_f64=False,
            segment=False):
    """Occlusion test: True where a ray (origins[i], dirs[i]) hits anything.

    ``origins``/``dirs`` are (R, 3) or 3-tuples of (R,) columns. With
    ``segment=True`` each ``dirs[i]`` is a segment vector (its far end at
    t = 1) and only occluders at 0 <= t <= 1 count — the shadow query
    toward a point light. The generic form stays well conditioned however
    far the light is; rays cast FROM the light (a common origin) would
    save features but form numerators as differences of terms ~ (light
    distance x triangle size), which in f32 leave cracks between adjacent
    occluders under a far light.
    ``origin_shift`` recenters the world for conditioning (see
    ceres_tpu.ops.intersect docstring); ``skip`` marks rays whose answer is
    irrelevant (no primary hit) so they generate no traversal work.
    ``clusters`` skips the structure build (see closest_hit_common_origin).
    Boolean, intentionally non-differentiable (detached visibility).
    ``with_counts=True`` additionally returns the measured traversal
    counters.
    """
    if exact_f64:
        from ceres_tpu.ops import walk_f64

        cs64 = clusters if clusters is not None else \
            cl.build_clusters_treelet(
                jax.tree.map(jax.lax.stop_gradient, soup))
        result, cnts = walk_f64.any_hit_f64(
            cs64, jnp.asarray(origin_shift), _cols(origins), _cols(dirs),
            skip=skip, segment=segment)
        if with_counts:
            cnts["mt_pairs"] = (cnts["mt_block_visits"]
                                * TILE * cs64.cluster_size)
            return result, cnts
        return result
    soup, shift, o_cols, d_cols = _detach_f32(
        (soup, origin_shift, _cols(origins), _cols(dirs)))
    R = d_cols[0].shape[0]
    # The build may promote under x64: the search runs in f32 regardless.
    cs = _detach_f32(cl.build_clusters_treelet(soup) if clusters is None
                     else clusters)
    w = cl.cluster_weights_generic_packed(cs, shift)
    lo = cs.lo - shift
    hi = cs.hi - shift
    root_lo, root_hi = _scene_root(cs)
    o = tuple(o_cols[a] - shift[a] for a in range(3))
    if skip is None:
        skip = jnp.zeros((R,), bool)
    dp = tuple(_pad_rays(c) for c in d_cols)
    op = tuple(_pad_rays(c) for c in o)
    dirs_tiled = tuple(c.reshape(-1, TILE) for c in dp)
    orig_tiled = tuple(c.reshape(-1, TILE) for c in op)
    skip_p = _pad_rays(skip)
    alive = ~skip_p.reshape(-1, TILE)
    alive = alive & ((dirs_tiled[0] * dirs_tiled[0]
                      + dirs_tiled[1] * dirs_tiled[1]
                      + dirs_tiled[2] * dirs_tiled[2]) > 0.0)
    dxo = (dp[1] * op[2] - dp[2] * op[1],
           dp[2] * op[0] - dp[0] * op[2],
           dp[0] * op[1] - dp[1] * op[0])
    # Padding rays are not skipped but have zero dirs -> tcap = -1, so they
    # never extend a tile's prune and never resolve to occluded.
    tcap = _ray_tcap(root_lo - shift, root_hi - shift, op, dp)
    if segment:
        # Nothing past the segment's end can occlude (padding rays keep -1).
        tcap = jnp.minimum(tcap, 1.0 + _ULP_PAD)
    feats = _feats_from_cols(dp + dxo + op, w.shape[1], tcap=tcap)
    occ0 = skip_p.astype(jnp.int32)
    S, hull, bbox, first, cull_lo, cull_hi, w = _hier_setup(
        lo, hi, dirs_tiled, alive, orig_tiled, w, cs=cs)
    keys, counts = _tile_candidate_keys(cull_lo, cull_hi, dirs_tiled,
                                        orig_tiled, alive)
    occ, steps = _walk_pallas(
        counts, keys, feats, w, occ0, hull=hull, bbox=bbox, first=first,
        K=10, mode="any_seg" if segment else "any",
        interpret=_walk_interpret(), S=S)
    steps = jnp.sum(steps)
    result = (occ.reshape(-1)[:R] == 1) & ~skip
    if with_counts:
        cnts = {"traversal_steps": steps, "mt_block_visits": steps,
                "mt_pairs": steps * TILE * cs.cluster_size}
        return result, cnts
    return result

