"""The ALL-f64 cluster walk (ceres_tpu.ops.walk_f64, VERDICT r4 item 7).

The accelerated ``-d`` mode searches on the f32 kernel datapath; on
geometry finer than f32 resolution the WINNER itself can be wrong, not
just a tie-break. These tests (a) pin the exact f64 walk against a
float64 brute-force oracle, (b) construct the precise f32-search
failure mode — two sheets closer together than one f32 ulp at their
magnitude — and show the exact walk resolves it while the accelerated
mode measurably cannot, and (c) check the end-to-end f64_exact render.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ceres_tpu.accel import clusters as cl
from ceres_tpu.models.mesh import triangle_soup
from ceres_tpu.ops import megakernel as mk


def _np_closest_f64(soup, eye, d):
    """NumPy float64 brute-force closest hit (prim ids, -1 = miss)."""
    p0 = np.asarray(soup.p0, np.float64)
    e1 = np.asarray(soup.e1, np.float64)
    e2 = np.asarray(soup.e2, np.float64)
    n = np.asarray(soup.n, np.float64)
    c = p0 - np.asarray(eye, np.float64)
    det = d @ n.T
    r = np.cross(d[:, None, :], c[None, :, :])
    u = np.einsum("rfa,fa->rf", r, e2)
    v = np.einsum("rfa,fa->rf", r, e1)
    tn = np.einsum("fa,fa->f", n, c)[None, :]
    s = np.where(det >= 0, 1.0, -1.0)
    uvw = np.minimum(np.minimum(u * s, v * s), (det - u - v) * s)
    ok = (np.minimum(uvw, tn * s) >= 0) & (det != 0)
    t = np.where(ok, tn / np.where(det != 0, det, 1.0), np.inf)
    best = t.min(axis=1)
    return np.where(np.isfinite(best), t.argmin(axis=1), -1), t


def test_exact_walk_matches_f64_oracle(rng):
    with jax.enable_x64():
        V, F, R = 80, 200, 600
        verts = rng.standard_normal((V, 3))
        faces = rng.integers(0, V, (F, 3)).astype(np.int32)
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        assert soup.p0.dtype == jnp.float64
        eye = jnp.asarray([0.0, 0.0, -4.0])
        d = rng.standard_normal((R, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        hit = mk.closest_hit_common_origin(
            soup, eye, jnp.asarray(d), exact_f64=True)
        prim_ref, t_all = _np_closest_f64(soup, eye, d)
        prim = np.where(np.asarray(hit.mask), np.asarray(hit.prim_id), -1)
        assert ((prim >= 0) == (prim_ref >= 0)).all()
        diff = np.nonzero(prim != prim_ref)[0]
        # Disagreements must be EXACT f64 ties (both prims at identical t).
        for i in diff:
            assert t_all[i, prim[i]] == t_all[i, prim_ref[i]]
        m = prim == prim_ref
        np.testing.assert_allclose(
            np.asarray(hit.t)[m & (prim >= 0)],
            t_all[np.arange(R), np.clip(prim, 0, None)][m & (prim >= 0)],
            rtol=1e-12)


def test_sub_f32_ulp_sheets():
    """Two sheets 0.0004 apart at z ~ 10000 (f32 ulp there is ~0.001):
    in f32 the records round to IDENTICAL triangles, so the accelerated
    search tie-breaks by slot order and picks whichever sheet comes
    first — here the FAR one, deterministically. The exact f64 walk must
    return the near sheet. This is the measured correctness gap the
    exact mode exists to close."""
    with jax.enable_x64():
        z_far = 10000.0004          # prim 0, packed at SLOT 0
        z_near = 10000.0            # prim 1, slot 1
        assert np.float32(z_far) == np.float32(z_near)  # sub-ulp apart
        verts = np.asarray([
            [-9000.0, -9000.0, z_far], [9000.0, -9000.0, z_far],
            [0.0, 9000.0, z_far],
            [-9000.0, -9000.0, z_near], [9000.0, -9000.0, z_near],
            [0.0, 9000.0, z_near],
        ])
        faces = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        # Pack the cluster EXPLICITLY with the far sheet in slot 0 so the
        # f32 exact-tie break (lowest slot wins) deterministically picks
        # the wrong sheet — morton order would otherwise pick the slot
        # order arbitrarily.
        C = 8
        pad = C - 2

        def pk(a):
            a = jnp.asarray(a)
            return jnp.concatenate(
                [a, jnp.zeros((pad, 3), a.dtype)])[None]
        pts = verts.reshape(2, 3, 3)
        cs = cl.ClusterSet(
            p0=pk(soup.p0), e1=pk(soup.e1), e2=pk(soup.e2), n=pk(soup.n),
            lo=jnp.asarray(pts.reshape(-1, 3).min(0))[None],
            hi=jnp.asarray(pts.reshape(-1, 3).max(0))[None],
            perm=jnp.asarray([0, 1] + [-1] * pad, jnp.int32))
        eye = jnp.asarray([0.0, 0.0, 0.0])
        dirs = jnp.asarray([[0.0, 0.0, 1.0]])

        acc = mk.closest_hit_common_origin(soup, eye, dirs, clusters=cs)
        exact = mk.closest_hit_common_origin(soup, eye, dirs, clusters=cs,
                                             exact_f64=True)
        # The accelerated search cannot separate the sheets: it returns
        # the far one (slot order), off by the full sheet gap.
        assert int(np.asarray(acc.prim_id)[0]) == 0
        assert int(np.asarray(exact.prim_id)[0]) == 1
        assert float(np.asarray(exact.t)[0]) == z_near
        gap = float(np.asarray(acc.t)[0]) - float(np.asarray(exact.t)[0])
        np.testing.assert_allclose(gap, 0.0004, rtol=1e-6)


def test_exact_occlusion_matches_kernel(rng):
    """On ordinary geometry the exact f64 occlusion modes must agree
    with the f32 kernel exactly (no near-ties constructed here)."""
    with jax.enable_x64():
        V, F, R = 80, 200, 400
        verts = rng.standard_normal((V, 3))
        faces = rng.integers(0, V, (F, 3)).astype(np.int32)
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        pts = rng.standard_normal((R, 3)) * 0.1
        seg = jnp.asarray([30.0, 45.0, -20.0]) - jnp.asarray(pts)
        center = jnp.mean(soup.p0, axis=0)
        a = np.asarray(mk.any_hit(soup, center, jnp.asarray(pts), seg,
                                  segment=True))
        b = np.asarray(mk.any_hit(soup, center, jnp.asarray(pts), seg,
                                  segment=True, exact_f64=True))
        assert (a == b).mean() > 0.995   # grazing accepts may flip

        dirs = rng.standard_normal((R, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        a2 = np.asarray(mk.any_hit(soup, center, jnp.asarray(pts),
                                   jnp.asarray(dirs)))
        b2 = np.asarray(mk.any_hit(soup, center, jnp.asarray(pts),
                                   jnp.asarray(dirs), exact_f64=True))
        assert (a2 == b2).mean() > 0.995


def test_f64_exact_render_matches_bruteforce_oracle(bunny):
    """End-to-end: RenderConfig(f64_exact=True) against the all-f64
    bruteforce oracle backend — winner-exact search on both sides, so
    the images must agree to f64 tightness (no silhouette budget)."""
    from ceres_tpu.render import scenes
    from ceres_tpu.render.renderer import RenderConfig, render

    with jax.enable_x64():
        scene = scenes.bunny_scene()
        v64 = np.asarray(scene.vertices, np.float64)
        s64 = np.asarray(scene.sun, np.float64)
        ref, ref_stats = render(
            v64, scene.faces, scene.camera, s64,
            config=RenderConfig(width=48, height=48, mode="smooth",
                                backend="bruteforce"))
        img, stats = render(
            v64, scene.faces, scene.camera, s64,
            config=RenderConfig(width=48, height=48, mode="smooth",
                                backend="megakernel", f64_exact=True))
        assert int(stats["primary_hits"]) == int(ref_stats["primary_hits"])
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-9)


def test_exact_f64_requires_x64():
    soup = triangle_soup(
        jnp.asarray(np.eye(3, dtype=np.float32)),
        jnp.asarray([[0, 1, 2]], np.int32), with_normals=False)
    with pytest.raises(ValueError, match="float64"):
        mk.closest_hit_common_origin(
            soup, jnp.zeros(3), jnp.asarray([[0.0, 0.0, 1.0]]),
            exact_f64=True)
