"""Megakernel (Pallas walk interpreted on the CPU) vs brute force and golden.

Mirrors SURVEY.md §4 item 3: traversal equivalence — the accelerated path
must reproduce the exhaustive all-triangles intersection on every ray.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ceres_tpu.accel import clusters as cl
from ceres_tpu.models.camera import Camera
from ceres_tpu.models.mesh import triangle_soup, TriangleSoup
from ceres_tpu.ops import intersect as mt
from ceres_tpu.ops import megakernel as mk
from ceres_tpu.render.renderer import render


def _random_scene(rng, V=60, F=120):
    verts = rng.standard_normal((V, 3)).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    return triangle_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False)


def _random_dirs(rng, R):
    d = rng.standard_normal((R, 3)).astype(np.float32)
    return jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))


class TestClusters:
    def test_perm_is_permutation(self, rng):
        soup = _random_scene(rng, F=150)
        cs = cl.build_clusters(soup)
        perm = np.asarray(cs.perm)
        real = perm[perm >= 0]
        assert sorted(real.tolist()) == list(range(150))
        assert (perm < 0).sum() == cs.num_clusters * cs.cluster_size - 150

    def test_aabbs_contain_triangles(self, rng):
        soup = _random_scene(rng)
        cs = cl.build_clusters(soup)
        pts = np.stack([np.asarray(cs.p0), np.asarray(cs.p0 - cs.e1),
                        np.asarray(cs.p0 + cs.e2)], axis=2)  # (N_c, C, 3, 3)
        valid = (np.asarray(cs.perm) >= 0).reshape(cs.num_clusters, cs.cluster_size)
        lo = np.asarray(cs.lo)[:, None, None, :]
        hi = np.asarray(cs.hi)[:, None, None, :]
        ok = ((pts >= lo - 1e-6) & (pts <= hi + 1e-6)).all(axis=(2, 3))
        assert ok[valid].all()

    def test_cluster_members_match_soup(self, rng):
        soup = _random_scene(rng)
        cs = cl.build_clusters(soup)
        perm = np.asarray(cs.perm)
        flat_p0 = np.asarray(cs.p0).reshape(-1, 3)
        valid = perm >= 0
        np.testing.assert_allclose(
            flat_p0[valid], np.asarray(soup.p0)[perm[valid]], rtol=0, atol=0)


class TestClosestHit:
    def test_matches_bruteforce(self, rng):
        soup = _random_scene(rng)
        eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
        dirs = _random_dirs(rng, 700)
        bf = mt.closest_hit_bruteforce(
            mt.ray_features_common_origin(dirs),
            mt.triangle_weights_common_origin(soup, eye))
        hit = mk.closest_hit_common_origin(soup, eye, dirs)
        np.testing.assert_array_equal(np.asarray(bf.mask), np.asarray(hit.mask))
        m = np.asarray(bf.mask)
        np.testing.assert_allclose(np.asarray(bf.t)[m], np.asarray(hit.t)[m],
                                   rtol=1e-4, atol=1e-5)
        assert (np.asarray(bf.prim_id)[m] == np.asarray(hit.prim_id)[m]).mean() > 0.99
        np.testing.assert_allclose(np.asarray(bf.u)[m], np.asarray(hit.u)[m],
                                   rtol=1e-3, atol=1e-4)

    def test_multi_cluster_scene(self, rng):
        # > cluster_size triangles so several clusters really exist.
        soup = _random_scene(rng, V=200, F=400)
        cs = cl.build_clusters(soup)
        assert cs.num_clusters >= 3
        eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
        dirs = _random_dirs(rng, 600)
        bf = mt.closest_hit_bruteforce(
            mt.ray_features_common_origin(dirs),
            mt.triangle_weights_common_origin(soup, eye))
        hit = mk.closest_hit_common_origin(soup, eye, dirs)
        np.testing.assert_array_equal(np.asarray(bf.mask), np.asarray(hit.mask))
        m = np.asarray(bf.mask)
        # Random soups contain grazing (near-zero-det) hits where t is
        # numerically unstable: the two paths may legitimately pick
        # different near-tie winners there (documented kernel tie-break
        # semantics), so t is compared where the winner AGREES and the
        # agreement fraction is asserted separately — the same structure
        # as test_matches_bruteforce.
        same = m & (np.asarray(bf.prim_id) == np.asarray(hit.prim_id))
        assert same[m].mean() > 0.95
        np.testing.assert_allclose(np.asarray(bf.t)[same],
                                   np.asarray(hit.t)[same],
                                   rtol=1e-4, atol=1e-5)


class TestAnyHit:
    def test_matches_bruteforce(self, rng):
        soup = _random_scene(rng)
        R = 600
        origins = jnp.asarray(rng.standard_normal((R, 3)).astype(np.float32) * 0.1
                              + np.array([0, 0, -4], np.float32))
        dirs = _random_dirs(rng, R)
        bf = mt.any_hit_bruteforce(mt.ray_features(origins, dirs),
                                   mt.triangle_weights(soup))
        center = jnp.mean(soup.p0, axis=0)
        occ = mk.any_hit(soup, center, origins, dirs)
        np.testing.assert_array_equal(np.asarray(bf), np.asarray(occ))

    def test_skip_mask(self, rng):
        soup = _random_scene(rng)
        R = 256
        origins = jnp.zeros((R, 3), jnp.float32) + jnp.asarray([0, 0, -4.0])
        dirs = _random_dirs(rng, R)
        skip = jnp.asarray(rng.random(R) < 0.5)
        center = jnp.mean(soup.p0, axis=0)
        occ = mk.any_hit(soup, center, origins, dirs, skip=skip)
        assert not np.asarray(occ)[np.asarray(skip)].any()


class TestSegmentShadow:
    """The renderer's shadow query: segment occlusion between each point
    and one shared light position (any_hit(..., segment=True))."""

    def test_matches_generic_when_light_outside_scene(self, rng):
        # With the light outside the scene bounds, "anything along the ray
        # toward the light" (the generic form, tmax = inf) and "anything
        # strictly between point and light" (the segment form) agree.
        soup = _random_scene(rng)
        R = 600
        points = jnp.asarray(
            rng.standard_normal((R, 3)).astype(np.float32) * 0.1
            + np.array([0, 0, -4], np.float32))
        dest = jnp.asarray([30.0, 45.0, -20.0], jnp.float32)
        dirs = dest[None, :] - points
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        center = jnp.mean(soup.p0, axis=0)
        occ_generic = mk.any_hit(soup, center, points, dirs)
        occ_seg = mk.any_hit(soup, center, points, dest[None, :] - points,
                             segment=True)
        # The two parameterizations round differently at triangle edges;
        # classification must agree except at a vanishing set of edge rays.
        agree = np.asarray(occ_generic) == np.asarray(occ_seg)
        assert agree.mean() > 0.995

    def test_occluder_beyond_light_does_not_shadow(self):
        # One triangle BEHIND the light w.r.t. the receiver: the
        # reference's unbounded ray darkens (any_hit); the segment test
        # must not (the physically-correct default, see
        # RenderConfig.reference_compat).
        verts = np.asarray([[-1, 10, -1], [1, 10, -1], [0, 10, 1]],
                           np.float32)
        faces = np.asarray([[0, 1, 2]], np.int32)
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        points = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
        dest = jnp.asarray([0.0, 5.0, 0.0], jnp.float32)  # below the tri
        up = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
        occ_generic = mk.any_hit(soup, jnp.zeros(3), points, up)
        occ_seg = mk.any_hit(soup, jnp.zeros(3), points,
                             dest[None, :] - points, segment=True)
        assert bool(np.asarray(occ_generic)[0])       # tmax=inf: darkened
        assert not bool(np.asarray(occ_seg)[0])       # segment: lit

    def test_occluder_between_shadows(self):
        verts = np.asarray([[-1, 2, -1], [1, 2, -1], [0, 2, 1]], np.float32)
        faces = np.asarray([[0, 1, 2]], np.int32)
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        points = jnp.asarray([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]], jnp.float32)
        dest = jnp.asarray([0.0, 5.0, 0.0], jnp.float32)
        occ = np.asarray(mk.any_hit(soup, jnp.zeros(3), points,
                                    dest[None, :] - points, segment=True))
        assert bool(occ[0])          # triangle sits between point and light
        assert not bool(occ[1])      # offset receiver: clear line

    def test_skip_mask(self, rng):
        soup = _random_scene(rng)
        R = 256
        points = jnp.asarray(
            rng.standard_normal((R, 3)).astype(np.float32) * 0.1)
        dest = jnp.asarray([30.0, 45.0, -20.0], jnp.float32)
        skip = jnp.asarray(rng.random(R) < 0.5)
        occ = mk.any_hit(soup, jnp.mean(soup.p0, axis=0), points,
                         dest[None, :] - points, skip=skip, segment=True)
        assert not np.asarray(occ)[np.asarray(skip)].any()

    def test_light_inside_scene_occluder_behind_light(self):
        # An IN-SCENE light (inside the candidate cluster's AABB, so
        # phase-1 culling cannot reject the cluster) with occluders on
        # both sides of the segment. The accept needs both bounds,
        # 0 <= t <= 1. Light at (0, 5, 0); receivers straight below at
        # the origin. Triangles (all crossed by the x=0, z=0 line, all in
        # ONE shared cluster):
        #   y = 10: behind the light (t = 2)         -> must NOT shadow
        #   y = -2: behind the receiver (t = -0.4)   -> must NOT shadow
        #   y =  2: strictly between (t = 0.4)       -> must shadow
        def scene(*ys):
            tri = np.asarray([[-1, 0, -1], [1, 0, -1], [0, 0, 1]],
                             np.float32)
            verts = np.concatenate(
                [tri + np.asarray([0, y, 0], np.float32) for y in ys])
            faces = np.arange(3 * len(ys), dtype=np.int32).reshape(-1, 3)
            return triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                                 with_normals=False)

        dest = jnp.asarray([0.0, 5.0, 0.0], jnp.float32)   # in scene AABB
        recv = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
        seg = dest[None, :] - recv
        occ_clear = np.asarray(mk.any_hit(scene(10.0, -2.0), jnp.zeros(3),
                                          recv, seg, segment=True))
        assert not bool(occ_clear[0])    # behind + beyond: lit
        occ_blocked = np.asarray(mk.any_hit(
            scene(10.0, -2.0, 2.0), jnp.zeros(3), recv, seg, segment=True))
        assert bool(occ_blocked[0])      # the between triangle shadows

    @pytest.mark.parametrize("hier", [False, True])
    def test_far_light_watertight(self, monkeypatch, hier):
        # A watertight sheet of 3,200 small triangles between every
        # receiver and a light ~10,000 sheet widths away: each segment
        # crosses the sheet, so every receiver is in shadow. Rays cast
        # FROM such a light form numerators as differences of terms
        # ~ (light distance x triangle size) and leave cracks along
        # shared edges in f32 (about 1 receiver in 1,000 here); the
        # segment form must leave none.
        if hier:
            monkeypatch.setattr(mk, "_HIER_MIN_CLUSTERS", 1)
        n = 40
        g = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
        gx, gz = np.meshgrid(g, g, indexing="ij")
        verts = np.stack([gx, np.ones_like(gx), gz], -1).reshape(-1, 3)
        idx = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
        a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
        c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
        faces = np.concatenate([np.stack([a, b, c], -1),
                                np.stack([a, c, d], -1)]).astype(np.int32)
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        rng = np.random.default_rng(7)
        recv = rng.uniform(-0.4, 0.4, (4000, 3)).astype(np.float32)
        recv[:, 1] = 0.0
        light = np.asarray([400.0, 20000.0, -260.0], np.float32)
        occ = np.asarray(mk.any_hit(
            soup, jnp.mean(soup.p0, axis=0), jnp.asarray(recv),
            jnp.asarray(light[None, :] - recv), segment=True))
        assert occ.all(), f"{(~occ).sum()} receivers lit through the sheet"


class TestTWindow:
    """Per-ray [tmin, tmax] on the megakernel closest hit — the bvh::Ray
    window (ray.hpp:9-23), exercised against the bruteforce oracle's
    native tmin/tmax support."""

    def _scene_two_planes(self):
        tri = np.asarray([[-2, -2, 0], [2, -2, 0], [0, 2, 0]], np.float32)
        verts = np.concatenate([tri + np.asarray([0, 0, 2], np.float32),
                                tri + np.asarray([0, 0, 5], np.float32)])
        faces = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
        return triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)

    def test_window_selects_far_triangle(self):
        soup = self._scene_two_planes()
        eye = jnp.zeros(3, jnp.float32)
        dirs = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        h0 = mk.closest_hit_common_origin(soup, eye, dirs)
        assert bool(h0.mask[0]) and int(h0.prim_id[0]) == 0
        h1 = mk.closest_hit_common_origin(soup, eye, dirs, tmin=3.0)
        assert bool(h1.mask[0]) and int(h1.prim_id[0]) == 1
        np.testing.assert_allclose(float(h1.t[0]), 5.0, rtol=1e-5)
        h2 = mk.closest_hit_common_origin(soup, eye, dirs, tmax=1.0)
        assert not bool(h2.mask[0])
        h3 = mk.closest_hit_common_origin(soup, eye, dirs, tmin=3.0,
                                          tmax=4.0)
        assert not bool(h3.mask[0])

    def test_per_ray_window_matches_bruteforce(self, rng):
        soup = _random_scene(rng, V=200, F=400)
        eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
        R = 512
        dirs = _random_dirs(rng, R)
        tmin = jnp.asarray(rng.uniform(0.0, 3.0, R).astype(np.float32))
        tmax = tmin + jnp.asarray(
            rng.uniform(0.5, 4.0, R).astype(np.float32))
        bf = mt.closest_hit_bruteforce(
            mt.ray_features_common_origin(dirs),
            mt.triangle_weights_common_origin(soup, eye),
            tmin=tmin[:, None], tmax=tmax[:, None])
        hit = mk.closest_hit_common_origin(soup, eye, dirs, tmin=tmin,
                                           tmax=tmax)
        agree = np.asarray(bf.mask) == np.asarray(hit.mask)
        assert agree.mean() > 0.995   # window-edge rounding only
        m = np.asarray(bf.mask) & np.asarray(hit.mask)
        np.testing.assert_allclose(np.asarray(bf.t)[m],
                                   np.asarray(hit.t)[m],
                                   rtol=1e-4, atol=1e-5)

    def test_window_hier_matches_flat(self, rng, monkeypatch):
        soup = _random_scene(rng, V=200, F=400)
        eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
        dirs = _random_dirs(rng, 400)
        flat = mk.closest_hit_common_origin(soup, eye, dirs, tmin=0.5,
                                            tmax=6.0)
        monkeypatch.setattr(mk, "_HIER_MIN_CLUSTERS", 1)
        hier = mk.closest_hit_common_origin(soup, eye, dirs, tmin=0.5,
                                            tmax=6.0)
        np.testing.assert_array_equal(np.asarray(flat.mask),
                                      np.asarray(hier.mask))
        m = np.asarray(flat.mask)
        np.testing.assert_allclose(np.asarray(flat.t)[m],
                                   np.asarray(hier.t)[m],
                                   rtol=1e-4, atol=1e-5)


class TestHierarchicalWalk:
    """The two-level walk (super candidates + in-kernel block gating)
    must match the flat walk exactly on every mode. Forced on tiny
    scenes by dropping the cluster threshold."""

    def _force_hier(self, monkeypatch):
        monkeypatch.setattr(mk, "_HIER_MIN_CLUSTERS", 1)

    def test_closest_matches_flat(self, rng, monkeypatch):
        soup = _random_scene(rng, V=200, F=400)
        eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
        dirs = _random_dirs(rng, 600)
        flat = mk.closest_hit_common_origin(soup, eye, dirs)
        self._force_hier(monkeypatch)
        hier = mk.closest_hit_common_origin(soup, eye, dirs)
        np.testing.assert_array_equal(np.asarray(flat.mask),
                                      np.asarray(hier.mask))
        m = np.asarray(flat.mask)
        assert (np.asarray(flat.prim_id)[m]
                == np.asarray(hier.prim_id)[m]).mean() > 0.99
        np.testing.assert_allclose(np.asarray(flat.t)[m],
                                   np.asarray(hier.t)[m],
                                   rtol=1e-4, atol=1e-5)

    def test_any_matches_flat(self, rng, monkeypatch):
        soup = _random_scene(rng, V=200, F=400)
        R = 400
        origins = jnp.asarray(
            rng.standard_normal((R, 3)).astype(np.float32) * 0.1
            + np.array([0, 0, -4], np.float32))
        dirs = _random_dirs(rng, R)
        center = jnp.mean(soup.p0, axis=0)
        flat = np.asarray(mk.any_hit(soup, center, origins, dirs))
        self._force_hier(monkeypatch)
        hier = np.asarray(mk.any_hit(soup, center, origins, dirs))
        np.testing.assert_array_equal(flat, hier)

    def test_any_seg_matches_flat(self, rng, monkeypatch):
        soup = _random_scene(rng, V=200, F=400)
        R = 400
        points = jnp.asarray(
            rng.standard_normal((R, 3)).astype(np.float32) * 0.1)
        seg = jnp.asarray([30.0, 45.0, -20.0], jnp.float32)[None] - points
        center = jnp.mean(soup.p0, axis=0)
        flat = np.asarray(mk.any_hit(soup, center, points, seg,
                                     segment=True))
        self._force_hier(monkeypatch)
        hier = np.asarray(mk.any_hit(soup, center, points, seg,
                                     segment=True))
        np.testing.assert_array_equal(flat, hier)


class TestRenderBackendEquivalence:
    def test_bunny_render_matches_bruteforce(self, bunny):
        verts, faces = bunny
        eye = (0.0, 0.1, -0.3)
        direction = tuple(verts.mean(axis=0) - np.asarray(eye, np.float32))
        cam = Camera.make(eye=eye, dir=direction, up=(0, 1, 0), fov=60.0)
        sun = np.asarray([-50.0, 100.0, 0.0], np.float32)
        img_b, _ = render(verts, faces, cam, sun, width=64, height=64,
                          backend="bruteforce")
        img_m, _ = render(verts, faces, cam, sun, width=64, height=64,
                          backend="megakernel")
        d = np.abs(np.asarray(img_b) - np.asarray(img_m)).max(axis=-1)
        # At most a couple of silhouette-tie pixels may differ.
        assert (d > 1e-3).mean() < 1e-3

    def test_gradients_match_bruteforce(self, bunny):
        verts, faces = bunny
        eye = (0.0, 0.1, -0.3)
        direction = tuple(verts.mean(axis=0) - np.asarray(eye, np.float32))
        cam = Camera.make(eye=eye, dir=direction, up=(0, 1, 0), fov=60.0)
        sun = np.asarray([-50.0, 100.0, 0.0], np.float32)

        def loss(v, backend):
            img, _ = render(v, faces, cam, sun, width=24, height=24,
                            backend=backend)
            return jnp.sum(img ** 2)

        gm = np.asarray(jax.grad(lambda v: loss(v, "megakernel"))(jnp.asarray(verts)))
        gb = np.asarray(jax.grad(lambda v: loss(v, "bruteforce"))(jnp.asarray(verts)))
        assert np.isfinite(gm).all()
        # atol scaled to the gradient magnitude: the two backends reduce in
        # different orders (swizzled tiles vs raster), so absolute f32 noise
        # tracks the largest gradient entries.
        np.testing.assert_allclose(gm, gb, rtol=1e-3,
                                   atol=3e-6 * np.abs(gb).max())


class TestPruneExitCidBits:
    """Adversarial near-tie with n_c > 256 (VERDICT r4 weakness 2).

    The candidate key packs (cleared entry bound | cluster id); the id
    bits raise the key above the pure entry bound by up to
    2^cid_bits - 1 ulps, which EXCEEDS the _PRUNE_PAD = 256 slack once
    n_c > 256. The walk's exit test must mask the id bits, or a
    candidate whose true entry is below the prune gets skipped — and
    because the exit ends the WHOLE walk, every remaining candidate is
    lost with it. This test constructs the exact boundary case and
    fails on the unmasked `key_k <= prune_i` exit.
    """

    def test_high_cid_candidate_still_visited(self):
        C = 8
        n_c = 1026            # cid_bits = 11 -> ids raise keys up to 2047 ulp
        cid_b = 1000          # > _PRUNE_PAD = 256
        R = 8

        def fbits(x):
            return int(np.float32(x).view(np.int32))

        def bitsf(i):
            return float(np.int32(i).view(np.float32))

        # Ray 1's tcap sits exactly on a 2048-ulp grid boundary so the
        # prune is boundary + 256 and any cid > 256 with a same-cell
        # entry bound pushes the unmasked key past it.
        tcap1 = 4.5
        assert fbits(tcap1) & 2047 == 0
        prune_after_a = fbits(tcap1) + mk._PRUNE_PAD
        entry_b_bits = fbits(tcap1) + 0x100     # same 2048-cell, <= prune
        t_b = bitsf(fbits(tcap1) + 0x200)       # true hit >= entry bound

        # Cluster 0: plane z=1 patch over ray 0 only. Cluster cid_b:
        # plane z=t_b patch over ray 1 only (ray 1 dir (1,0,1): x=z).
        tris = {
            0: [(-0.5, -0.5, 1.0), (0.5, -0.5, 1.0), (0.0, 0.5, 1.0)],
            cid_b: [(3.0, -2.0, t_b), (6.0, -2.0, t_b), (4.5, 2.0, t_b)],
        }
        p0 = np.zeros((n_c, C, 3), np.float32)
        e1 = np.zeros((n_c, C, 3), np.float32)
        e2 = np.zeros((n_c, C, 3), np.float32)
        nn = np.zeros((n_c, C, 3), np.float32)
        for cid, (a, b, c) in tris.items():
            a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
            p0[cid, 0] = a
            e1[cid, 0] = a - b
            e2[cid, 0] = c - a
            nn[cid, 0] = np.cross(e1[cid, 0], e2[cid, 0])
        cs = cl.ClusterSet(
            p0=jnp.asarray(p0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
            n=jnp.asarray(nn),
            lo=jnp.zeros((n_c, 3)), hi=jnp.zeros((n_c, 3)),
            perm=jnp.full((n_c * C,), -1, jnp.int32))
        w = cl.cluster_weights_common_origin_packed(cs, jnp.zeros((3,)))

        dirs = np.zeros((3, R), np.float32)
        dirs[:, 0] = [0.0, 0.0, 1.0]       # hits cluster 0 at t = 1.0
        dirs[:, 1] = [1.0, 0.0, 1.0]       # hits cluster cid_b at t = t_b
        tcap = np.full((R,), -1.0, np.float32)
        tcap[0] = 2.0
        tcap[1] = tcap1
        feats = mk._feats_from_cols(
            tuple(jnp.asarray(dirs[a]) for a in range(3)), w.shape[1],
            tcap=jnp.asarray(tcap))

        cmask = (1 << mk._cid_bits(n_c)) - 1
        key_a = (fbits(0.9) & ~cmask) | 0
        key_b = (entry_b_bits & ~cmask) | cid_b
        assert key_b > prune_after_a          # unmasked exit would fire
        assert (key_b & ~cmask) <= prune_after_a
        keys = np.full((1, n_c), 0x7F000000, np.int32)
        keys[0, 0] = key_a
        keys[0, 1] = key_b
        counts = np.asarray([2], np.int32)

        pidx, steps = mk._walk_pallas(
            jnp.asarray(counts), jnp.asarray(keys), feats, w,
            K=4, mode="closest", interpret=True)
        pidx = np.asarray(pidx)
        assert pidx[0] == 0                       # cluster 0, slot 0
        assert pidx[1] == cid_b * C + 0           # the near-tie candidate
        assert int(np.asarray(steps).sum()) == 2  # both candidates visited


def test_prebuilt_winner_table_matches(bunny):
    """closest_hit with a hoisted winner table (prepare_winner_table)
    must be bit-identical to the inline build."""
    from ceres_tpu.models.mesh import triangle_soup as ts
    from ceres_tpu.render.renderer import (RenderConfig, render_pipeline,
                                           prepare_winner_table)
    from ceres_tpu.accel.clusters import build_clusters_treelet

    verts, faces = bunny
    vj, fj = jnp.asarray(verts), jnp.asarray(faces)
    cfg = RenderConfig(width=48, height=48, mode="smooth",
                       backend="megakernel")
    soup = ts(vj, fj, with_normals=True)
    cs = build_clusters_treelet(ts(vj, fj, with_normals=False))
    table = prepare_winner_table(soup, cs, cfg)
    ref, ref_stats = render_pipeline(vj, fj, *_bunny_cam_sun(verts), cfg,
                                     clusters=cs)
    img, stats = render_pipeline(vj, fj, *_bunny_cam_sun(verts), cfg,
                                 clusters=cs, table_cols=table)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))
    assert int(stats["primary_hits"]) == int(ref_stats["primary_hits"])


def _bunny_cam_sun(verts):
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    cam = Camera.make(eye=eye, dir=np.asarray(verts).mean(axis=0) - eye,
                      up=(0, 1, 0), fov=60.0)
    return cam, jnp.asarray([-50.0, 100.0, 0.0], jnp.float32)
