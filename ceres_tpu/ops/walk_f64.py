"""The tile walk in plain JAX: the all-float64 search, and the plain
version of the walk kernel.

The megakernel's ``-d`` mode is ACCELERATED f64: the winner/occlusion
search runs the f32 walk kernel and observables are recomputed in
f64 at the winners (megakernel._detach_f32). That is tight on ordinary
scenes but the winner itself can be wrong on pathological geometry —
coordinate spans beyond 2^24, or sheets closer together than f32
resolution at their magnitude (the reference's ``Scalar=double`` mode
searches in double everywhere, include/anim.cpp:154-158). This module
closes that gap without the O(R x T) f64 bruteforce: the SAME two-phase
design — interval culling prepass + per-tile front-to-back walk with a
conservative early exit — built from dtype-generic jnp ops so the whole
search runs in float64.

Shape: the prepass (megakernel._interval_entry, run in f64) yields each
tile's candidate clusters sorted by entry bound; a lockstep FRONTIER
loop then advances every still-active tile through its own list —
iteration k evaluates each active tile's k-th candidate (one gather +
one batched f64 Möller-Trumbore per step), and a tile retires when its
next entry bound exceeds its prune (max over rays of min(best t, root
exit)) — the kernel's early exit, exact in f64 with no prune pad (there
is no understatement source: entries are conservatively widened, the
carried t is exact). Tiles are processed in chunks of _CHUNK so the
per-step (chunk, R, C) f64 intermediates stay bounded.

The walk is dtype-generic: it searches in the ClusterSet's dtype. The
``*_f64`` entry points are the exact-double mode (they require a float64
ClusterSet and jax_enable_x64); ``closest_search``/``any_hit`` in
float32 are the plain version XLA compiles of what the Pallas walk
kernel does — its test reference and the baseline
the kernel's speed is measured against (benchmarks/walk_ab.py). Its
products pin Precision.HIGHEST, so float32 never runs as TF32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ceres_tpu.ops import megakernel as mk

_CHUNK = 64          # tiles per lockstep frontier (bounds f64 intermediates)


def _cross_cols(u, v):
    return jnp.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                      u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                      u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]],
                     axis=-1)


def _prepass(cs, shift, dir_cols, origin_cols=None, alive_cols=None):
    """Sorted f64 candidate lists. Returns (order, ent_sorted, counts,
    dirs_tiled (n_t, TILE, 3), origins_tiled or None, alive (n_t, TILE))."""
    dp = tuple(mk._pad_rays(c) for c in dir_cols)
    dirs_tiled = tuple(c.reshape(-1, mk.TILE) for c in dp)
    if alive_cols is None:
        alive = (dirs_tiled[0] ** 2 + dirs_tiled[1] ** 2
                 + dirs_tiled[2] ** 2) > 0.0
    else:
        alive = mk._pad_rays(alive_cols).reshape(-1, mk.TILE)
        alive = alive & ((dirs_tiled[0] ** 2 + dirs_tiled[1] ** 2
                          + dirs_tiled[2] ** 2) > 0.0)
    lo = cs.lo - shift
    hi = cs.hi - shift
    dlo, dhi = mk._hull(dirs_tiled, alive)
    orig_tiled = None
    if origin_cols is not None:
        op = tuple(mk._pad_rays(c) for c in origin_cols)
        orig_tiled = tuple(c.reshape(-1, mk.TILE) for c in op)
        olo, ohi = mk._hull(orig_tiled, alive)
        ent = mk._interval_entry(lo, hi, dlo, dhi, olo, ohi)
    else:
        ent = mk._interval_entry(lo, hi, dlo, dhi)
    ent = jnp.where(jnp.any(alive, axis=1)[:, None], ent, mk._BIG)
    order = jnp.argsort(ent, axis=1).astype(jnp.int32)
    ent_sorted = jnp.take_along_axis(ent, order, axis=1)
    counts = jnp.sum(ent_sorted < mk._VALID_CUT, axis=1).astype(jnp.int32)
    d3 = jnp.stack(dirs_tiled, axis=-1)
    o3 = None if orig_tiled is None else jnp.stack(orig_tiled, axis=-1)
    return order, ent_sorted, counts, d3, o3, alive


def _pad_chunk(x, n_pad):
    if n_pad:
        x = jnp.pad(x, ((0, n_pad),) + ((0, 0),) * (x.ndim - 1))
    return x


@functools.partial(jax.jit, static_argnames=("mode", "window"))
def _walk(cs, shift, order, ent_sorted, counts, d3, o3, alive, tcap,
          tmin_t=None, tmax_t=None, occ0=None, *, mode, window=False):
    """Chunked frontier walk. Returns (out (n_t, TILE), steps scalar).

    out: packed winner slot ids (closest; -1 miss) or occlusion flags.
    """
    n_t, n_c = ent_sorted.shape
    C = cs.cluster_size
    n_pad = (-n_t) % _CHUNK
    data = dict(order=order, ent=ent_sorted, counts=counts, d3=d3,
                alive=alive, tcap=tcap)
    if o3 is not None:
        data["o3"] = o3
    if window:
        data["tmin"] = tmin_t
        data["tmax"] = tmax_t
    if occ0 is not None:
        data["occ0"] = occ0
    data = {k: _pad_chunk(v, n_pad) for k, v in data.items()}
    data = {k: v.reshape((-1, _CHUNK) + v.shape[1:])
            for k, v in data.items()}
    dtype = cs.p0.dtype
    any_mode = mode in ("any", "any_seg")

    def mt_step(cid, ch):
        """f64 MT of every (active tile's candidate cluster) x rays.

        cid (_CHUNK,) cluster ids -> ok (_CHUNK, TILE, C), t likewise
        (inf where rejected).
        """
        p0 = cs.p0[cid] - shift                     # (_CHUNK, C, 3)
        e1 = cs.e1[cid]
        e2 = cs.e2[cid]
        nn = cs.n[cid]
        cu = _cross_cols(p0, e2)
        cv = _cross_cols(p0, e1)
        d = ch["d3"]                                # (_CHUNK, TILE, 3)
        mm = functools.partial(jnp.einsum, "tra,tca->trc",
                               precision=jax.lax.Precision.HIGHEST)
        nu = mm(d, cu)
        nv = mm(d, cv)
        nd = mm(d, nn)
        nt = jnp.sum(nn * p0, axis=-1)[:, None, :]  # (_CHUNK, 1, C)
        if "o3" in ch:
            o = ch["o3"]
            dxo = _cross_cols(d, o)                 # (_CHUNK, TILE, 3)
            nu = nu - mm(dxo, e2)
            nv = nv - mm(dxo, e1)
            nt = nt - mm(o, nn)
        s = jnp.where(nd >= 0, jnp.asarray(1.0, dtype),
                      jnp.asarray(-1.0, dtype))
        uvw = jnp.minimum(jnp.minimum(nu * s, nv * s),
                          (nd - nu - nv) * s)
        ok = (jnp.minimum(uvw, nt * s) >= 0) & (nd != 0)
        if mode == "any_seg":
            ok = ok & ((nt - nd) * s <= 0)                 # t <= 1
        t = jnp.where(ok, nt / jnp.where(nd != 0, nd, 1.0), jnp.inf)
        if window:
            t = jnp.where((t >= ch["tmin"][..., None])
                          & (t <= ch["tmax"][..., None]), t, jnp.inf)
        return ok, t

    def do_chunk(ch):
        tcap_c = jnp.where(ch["alive"], ch["tcap"],
                           jnp.asarray(-1.0, dtype))
        if any_mode:
            occ = ch["occ0"] > 0

            def prune_of(occ_):
                return jnp.max(jnp.where(occ_, jnp.asarray(-1.0, dtype),
                                         tcap_c), axis=1)
        else:
            t_best = jnp.full((_CHUNK, mk.TILE), jnp.inf, dtype)
            slot = jnp.full((_CHUNK, mk.TILE), -1, jnp.int32)

            def prune_of(tb):
                return jnp.max(jnp.minimum(tb, tcap_c), axis=1)

        def act_of(k, prune):
            ent_k = jax.lax.dynamic_slice_in_dim(
                ch["ent"], jnp.minimum(k, n_c - 1), 1, axis=1)[:, 0]
            return (k < ch["counts"]) & (ent_k <= prune)

        if any_mode:
            def cond(st):
                k, occ, steps = st
                return (k < n_c) & jnp.any(act_of(k, prune_of(occ)))

            def body(st):
                k, occ, steps = st
                act = act_of(k, prune_of(occ))
                cid = jax.lax.dynamic_slice_in_dim(
                    ch["order"], jnp.minimum(k, n_c - 1), 1, axis=1)[:, 0]
                ok, _ = mt_step(cid, ch)
                hit = jnp.any(ok, axis=2) & ch["alive"]
                occ = occ | (hit & act[:, None])
                return k + 1, occ, steps + jnp.sum(act).astype(jnp.int32)

            _, occ, steps = jax.lax.while_loop(
                cond, body, (jnp.int32(0), occ, jnp.int32(0)))
            return occ.astype(jnp.int32), steps

        def cond(st):
            k, tb, sl, steps = st
            return (k < n_c) & jnp.any(act_of(k, prune_of(tb)))

        def body(st):
            k, tb, sl, steps = st
            act = act_of(k, prune_of(tb))
            cid = jax.lax.dynamic_slice_in_dim(
                ch["order"], jnp.minimum(k, n_c - 1), 1, axis=1)[:, 0]
            _, t = mt_step(cid, ch)
            t_c = jnp.min(t, axis=2)                 # (_CHUNK, TILE)
            lane = jnp.argmin(t, axis=2).astype(jnp.int32)
            better = act[:, None] & ch["alive"] & (t_c < tb)
            tb = jnp.where(better, t_c, tb)
            sl = jnp.where(better, cid[:, None] * C + lane, sl)
            return k + 1, tb, sl, steps + jnp.sum(act).astype(jnp.int32)

        _, t_best, slot, steps = jax.lax.while_loop(
            cond, body, (jnp.int32(0), t_best, slot, jnp.int32(0)))
        return slot, steps

    outs, steps = jax.lax.map(do_chunk, data)
    out = outs.reshape(-1, mk.TILE)[:n_t]
    return out, jnp.sum(steps)


def _require_f64(cs):
    """The exact mode searches in the ClusterSet's dtype: refuse a float32
    one (the accelerated path's usual artifact) instead of silently
    running the whole 'Scalar=double' search in float32."""
    if cs.p0.dtype != jnp.float64:
        raise ValueError(f"the exact-f64 walk needs a float64 ClusterSet, "
                         f"got {cs.p0.dtype} (build it from a float64 "
                         f"soup with jax_enable_x64)")


def closest_search_f64(cs, eye, dir_cols, tmin=None, tmax=None):
    """All-f64 winner search; drop-in for megakernel._closest_search."""
    _require_f64(cs)
    return closest_search(cs, eye, dir_cols, tmin=tmin, tmax=tmax)


def any_hit_f64(cs, origin_shift, origin_cols, dir_cols, skip=None,
                segment=False):
    """All-f64 generic-ray occlusion (megakernel.any_hit semantics)."""
    _require_f64(cs)
    return any_hit(cs, origin_shift, origin_cols, dir_cols, skip=skip,
                   segment=segment)


def closest_search(cs, eye, dir_cols, tmin=None, tmax=None):
    """Winner search in the ClusterSet's dtype.

    Returns (packed slot ids (R,), counters dict). ``eye`` and the rays
    must share that dtype; the structure is the SAME ClusterSet the
    accelerated path uses — only the search math changes.
    """
    cs = jax.tree.map(jax.lax.stop_gradient, cs)
    eye = jax.lax.stop_gradient(eye)
    dir_cols = tuple(jax.lax.stop_gradient(c) for c in dir_cols)
    R = dir_cols[0].shape[0]
    order, ent, counts, d3, _, alive = _prepass(cs, eye, dir_cols)
    root_lo, root_hi = mk._scene_root(cs)
    dp = tuple(mk._pad_rays(c) for c in dir_cols)
    tcap = mk._ray_tcap(root_lo - eye, root_hi - eye, None, dp)
    tcap_t = tcap.reshape(-1, mk.TILE)
    window = tmin is not None or tmax is not None
    tmin_t = tmax_t = None
    if window:
        dt = cs.p0.dtype
        tmin_a = (jnp.zeros((R,), dt) if tmin is None
                  else jnp.broadcast_to(jnp.asarray(tmin, dt), (R,)))
        tmax_a = (jnp.full((R,), mk._BIG, dt) if tmax is None
                  else jnp.broadcast_to(jnp.asarray(tmax, dt), (R,)))
        tmin_t = mk._pad_rays(tmin_a).reshape(-1, mk.TILE)
        tmax_t = mk._pad_rays(tmax_a).reshape(-1, mk.TILE)
        tcap_t = jnp.where(tcap_t < 0, tcap_t,
                           jnp.minimum(tcap_t,
                                       tmax_t * (1.0 + mk._ULP_PAD)))
    slot, steps = _walk(cs, eye, order, ent, counts, d3, None, alive,
                        tcap_t, tmin_t, tmax_t, mode="closest",
                        window=window)
    return slot.reshape(-1)[:R], {"traversal_steps": steps,
                                  "mt_block_visits": steps}


def any_hit(cs, origin_shift, origin_cols, dir_cols, skip=None,
            segment=False):
    """Generic-ray occlusion (megakernel.any_hit semantics; ``segment``
    keeps only occluders at t <= 1)."""
    cs = jax.tree.map(jax.lax.stop_gradient, cs)
    R = dir_cols[0].shape[0]
    o = tuple(origin_cols[a] - origin_shift[a] for a in range(3))
    if skip is None:
        skip = jnp.zeros((R,), bool)
    skip_p = mk._pad_rays(skip)
    alive_cols = ~skip
    order, ent, counts, d3, o3, alive = _prepass(
        cs, origin_shift, dir_cols, o, alive_cols)
    root_lo, root_hi = mk._scene_root(cs)
    dp = tuple(mk._pad_rays(c) for c in dir_cols)
    op = tuple(mk._pad_rays(c) for c in o)
    tcap = mk._ray_tcap(root_lo - origin_shift, root_hi - origin_shift,
                        op, dp)
    if segment:
        tcap = jnp.minimum(tcap, 1.0 + mk._ULP_PAD)
    occ0 = skip_p.astype(jnp.int32).reshape(-1, mk.TILE)
    occ, steps = _walk(cs, origin_shift, order, ent, counts, d3, o3,
                       alive, tcap.reshape(-1, mk.TILE), occ0=occ0,
                       mode="any_seg" if segment else "any")
    return ((occ.reshape(-1)[:R] > 0) & ~skip,
            {"traversal_steps": steps, "mt_block_visits": steps})

