"""The render pipeline: primary rays -> closest hit -> shadow ray -> shading.

Pipeline parity with the reference render() (include/render.hpp:86-156):

  1. Pinhole camera rays for every pixel (one ray per pixel, at centers).
  2. Closest-hit intersection against the scene.
  3. Miss -> black. Hit -> hit point u*p0 + v*p1 + (1-u-v)*p2, offset by
     -1e-5 * normalize(face_normal) against self-intersection (render.hpp:131-133).
  4. Shadow ray toward the sun; any occluder (even beyond the sun, as in the
     reference, which uses tmax = +inf) -> black.
  5. Otherwise Gouraud smooth shading from the corner vertex normals.

Structure: rays are a flat wavefront, intersection is the matmul
Möller-Trumbore (ceres_tpu.ops.intersect) — either brute-force (reference
backend) or the cluster walk of ceres_tpu.ops.megakernel (fast backend). The
whole pipeline is jittable and differentiable w.r.t. vertices, camera and
sun position (visibility/hit-ids are detached, the standard differentiable
rendering convention).

Stats parity (render.hpp:102,115,119,138,148): "rays" counts traversals
(one per pixel + one per primary hit for the shadow ray), "hits" counts
primary hits + occluded shadow rays — the numbers anim.cpp:109-110 prints.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ceres_tpu.models.camera import Camera, camera_rays
from ceres_tpu.models.mesh import TriangleSoup, triangle_soup
from ceres_tpu.models import shading as shading_mod
from ceres_tpu.ops import intersect as mt

SELF_INTERSECT_OFFSET = -1e-5  # render.hpp:132


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable: safe as a jit static argument)."""

    width: int = 1920
    height: int = 1080
    mode: str = "smooth"       # "smooth" | "flat" | "normal"
    backend: str = "bruteforce"  # "megakernel" | "bruteforce"
    shadows: bool = True
    # Also report traversal_steps / intersections counters — the library's
    # Statistics mechanism (single_ray_traverser.hpp:131-163), distinct
    # from the app-level rays/hits counts (SURVEY.md §3.5 wants both).
    traversal_stats: bool = False
    # Reproduce the reference's EXACT behavior where the default deviates:
    # (1) barycentric assignment: hit point u*p0 + v*p1 + (1-u-v)*p2
    #     (render.hpp:127-129) and Gouraud corner weights (u, v, 1-u-v)
    #     (render.hpp:76-83). That assignment mis-pairs the MT (u, v)
    #     with the corners — the interpolated "hit point" does not lie on
    #     the ray — so the default (False) interpolates correctly
    #     ((1-u-v, u, v), hit point = eye + t*view).
    # (2) shadow rays: the reference uses tmax = inf (render.hpp:134-141),
    #     so geometry BEYOND the sun also darkens; the default runs the
    #     physically-correct [point, sun] segment test on the megakernel
    #     backend.
    # This flag exists to make reference parity bit-testable
    # (tests/test_reference_compat.py checks it against a PPM rendered by
    # the actual C++ reference).
    reference_compat: bool = False
    # ALL-f64 traversal on the megakernel backend (requires float64
    # inputs + jax_enable_x64): winner/occlusion search runs the
    # plain-JAX f64 cluster walk (ceres_tpu.ops.walk_f64) instead of the
    # f32 walk kernel — the reference's Scalar=double semantics with no
    # f32 anywhere in the search. Slower; for scenes where f32 search
    # resolution is insufficient (coordinate spans > 2^24, sheets closer
    # than f32 ulp).
    f64_exact: bool = False


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def _scene_center(soup: TriangleSoup):
    # Shift the world to the scene reference point so |o| stays small in the
    # d x o feature terms (conditioning; the result is shift-invariant).
    return jax.lax.stop_gradient(jnp.mean(soup.p0, axis=0))


def _closest_primary(soup: TriangleSoup, camera: Camera, dirs, backend: str,
                     clusters=None) -> mt.Hit:
    """Closest hit for the common-origin primary wavefront."""
    if backend == "bruteforce":
        w = mt.triangle_weights_common_origin(soup, camera.eye)
        f = mt.ray_features_common_origin(dirs)
        return mt.closest_hit_bruteforce(f, w)
    elif backend == "megakernel":
        from ceres_tpu.ops import megakernel

        return megakernel.closest_hit_common_origin(soup, camera.eye, dirs,
                                                    clusters=clusters)
    raise ValueError(f"unknown backend: {backend}")


def _any_shadow(soup: TriangleSoup, origins, dirs, backend: str, skip=None,
                clusters=None):
    """Occlusion test for the generic-origin shadow wavefront."""
    center = _scene_center(soup)
    if backend == "bruteforce":
        w = mt.triangle_weights(soup, origin_shift=center)
        f = mt.ray_features(origins - center, dirs)
        return mt.any_hit_bruteforce(f, w)
    elif backend == "megakernel":
        from ceres_tpu.ops import megakernel

        return megakernel.any_hit(soup, center, origins, dirs, skip=skip,
                                  clusters=clusters)
    raise ValueError(f"unknown backend: {backend}")


def _payload_cols(soup: TriangleSoup, config: RenderConfig):
    """The per-triangle shading payload columns for this config.

    Payload is a list of per-triangle COLUMNS (each (T,)): the winner
    gather is per-column, keeping every gathered array a dense column.
    Returns (payload, n_pay) where
    n_pay is the index of the first compat-vertex column in the
    RETURNED winner payload (face normal x3 prepended by
    normal_cols=True).
    """
    payload = []
    if config.mode == "smooth":
        if soup.corner_normals is None:
            raise ValueError("smooth shading requires corner_normals")
        cn = soup.corner_normals
        payload += [cn[:, k, a] for k in range(3) for a in range(3)]
    n_pay = len(payload) + 3
    if config.reference_compat:
        # The compat hit point needs the winner's vertices; they ride the
        # same winner gather as the shading payload.
        for arr in (soup.p0, soup.e1, soup.e2):
            payload += [arr[:, a] for a in range(3)]
    return payload, n_pay


def prepare_winner_table(soup: TriangleSoup, clusters,
                         config: RenderConfig):
    """Loop-invariant winner table for static-geometry frame loops.

    Pair of the prebuilt ``clusters`` fast lane (the reference builds
    its BVH before the frame loop, anim.cpp:62-66): the winner-gather
    table scales with the scene (N_c * C rows). Inside a jitted frame
    loop XLA may hoist the construction itself; this makes the hoist
    explicit and serves eager per-frame callers. Build once beside the
    clusters and pass to render_pipeline/render_wavefront(...,
    table_cols=...).
    """
    from ceres_tpu.ops import megakernel

    payload, _ = _payload_cols(soup, config)
    return megakernel.winner_table(soup, clusters, payload)


def render_wavefront_cols(
    soup: TriangleSoup,
    camera: Camera,
    sun_position: jax.Array,
    dir_cols,       # 3-tuple of (R,) normalized primary direction columns
    config: RenderConfig,
    clusters=None,  # prebuilt ClusterSet: skips the per-call structure
                    # build (frame loops over static geometry). Fully
                    # differentiable — the structure only drives the
                    # detached winner search.
    spheres=None,   # optional (centers (S, 3), radii (S,)): bvh::Sphere
                    # primitives merged into the scene by closest t
    table_cols=None,  # prebuilt winner table (prepare_winner_table)
):
    """Column-form wavefront render -> (3-tuple of (R,) colors, stats).

    The megakernel fast path: all per-ray math is structure-of-arrays
    ((R,) columns, no minor dimension of size 3). Everything shading
    needs per hit rides the single winner row-gather as a payload
    (megakernel._winner_table).
    """
    from ceres_tpu.ops import megakernel

    want_counts = config.traversal_stats
    # See _payload_cols for the payload layout; the face normal is NOT
    # in the payload: normal_cols=True prepends it recomputed from the
    # winner's edge columns (three fewer 8 MB gathers per frame), so the
    # returned ``pay`` reads [n x3, corners x9?, compat verts x9?].
    payload, n_pay = _payload_cols(soup, config)
    res = megakernel.closest_hit_common_origin(
        soup, camera.eye, dir_cols, clusters=clusters, payload=payload,
        with_counts=want_counts, normal_cols=True,
        exact_f64=config.f64_exact, table_cols=table_cols)
    (hit, pay), counts1 = (res[:2], res[2]) if want_counts else (res, None)
    mask = hit.mask
    n = (pay[0], pay[1], pay[2])
    # Normalize the face normal with a miss guard: payload rows are zero
    # at misses and a NaN there would leak into gradients through where.
    nsq = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    n_inv = jax.lax.rsqrt(jnp.where(mask, nsq, 1.0))
    if config.reference_compat:
        # The reference's exact interpolation u*p0 + v*p1 + (1-u-v)*p2
        # (render.hpp:127-129) — mis-assigned weights, the point is off-ray.
        w_bar = 1.0 - hit.u - hit.v
        point = tuple(
            hit.u * pay[n_pay + a]
            + hit.v * (pay[n_pay + a] - pay[n_pay + 3 + a])   # p1=p0-e1
            + w_bar * (pay[n_pay + 6 + a] + pay[n_pay + a])   # p2=e2+p0
            + SELF_INTERSECT_OFFSET * n[a] * n_inv
            for a in range(3))
    else:
        # Hit point via o + t*d — identical to the true-barycentric
        # interpolation (w, u, v) over (p0, p1, p2) but gather-free. NOTE
        # this deliberately DIFFERS from the reference, whose interpolation
        # u*p0 + v*p1 + w*p2 (render.hpp:127-129) mis-assigns the weights:
        # its "hit point" does not lie on the ray, shifting shadow origins
        # and producing shading seams across shared edges. Set
        # config.reference_compat for the reference's exact behavior.
        t_safe = jnp.where(mask, hit.t, 0.0)
        point = tuple(
            camera.eye[a] + t_safe * dir_cols[a]
            + SELF_INTERSECT_OFFSET * n[a] * n_inv
            for a in range(3))
    u_eff, v_eff = hit.u, hit.v
    corner_cols = pay[3:12] if config.mode == "smooth" else None
    sph_win = None
    if spheres is not None:
        # bvh::Sphere primitives (sphere.hpp:13-61) merged by closest t.
        # The sphere count of any plausible scene is tiny next to
        # triangles, so spheres run the dense column pair test; the
        # winner overrides point/normal columns, and smooth shading sees
        # the exact sphere normal on all three "corners" (Gouraud
        # degenerates to per-pixel normal shading).
        from ceres_tpu.ops import sphere as sphere_ops

        centers, radii = spheres
        s_t, s_mask, _, s_nrm = sphere_ops.closest_hit_common_origin_cols(
            camera.eye, dir_cols, centers, radii)
        t_tri = jnp.where(mask, hit.t, jnp.inf)
        sph_win = s_mask & (s_t < t_tri)
        mask = mask | s_mask
        st_safe = jnp.where(sph_win, s_t, 0.0)
        # Offset along the OUTWARD normal (toward the viewer for front
        # hits) — the sign mirrors the triangles' -1e-5 * n, whose
        # left-handed n points into the surface for CCW meshes.
        point = tuple(
            jnp.where(sph_win,
                      camera.eye[a] + st_safe * dir_cols[a]
                      - SELF_INTERSECT_OFFSET * s_nrm[a],
                      point[a])
            for a in range(3))
        n = tuple(jnp.where(sph_win, s_nrm[a], n[a]) for a in range(3))
        u_eff = jnp.where(sph_win, 0.0, u_eff)
        v_eff = jnp.where(sph_win, 0.0, v_eff)
        if corner_cols is not None:
            corner_cols = [jnp.where(sph_win, s_nrm[j % 3], corner_cols[j])
                           for j in range(9)]
    sl = tuple(sun_position[a] - point[a] for a in range(3))
    sl_inv = jax.lax.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
    sun_line = tuple(c * sl_inv for c in sl)

    counts2 = None
    if config.shadows:
        if config.reference_compat:
            # The reference's exact query: an unbounded ray from the hit
            # point toward the sun (tmax = inf, render.hpp:134-141), so
            # occluders BEYOND the sun darken too. Generic-ray form.
            res2 = megakernel.any_hit(
                soup, _scene_center(soup), point, sun_line, skip=~mask,
                clusters=clusters, with_counts=want_counts,
                exact_f64=config.f64_exact)
        else:
            # Physically-correct segment test: from the hit point to the
            # sun (t = 1 at the sun), generic-ray form, which stays exact
            # to f32 however far the sun is (see megakernel.any_hit).
            # Miss pixels ride along
            # as skip-masked lanes: they never extend a tile's prune, and
            # all-miss tiles exit the walk at once.
            res2 = megakernel.any_hit(
                soup, _scene_center(soup), point, sl, skip=~mask,
                clusters=clusters, with_counts=want_counts,
                exact_f64=config.f64_exact, segment=True)
        occluded, counts2 = res2 if want_counts else (res2, None)
        if spheres is not None:
            # Spheres occlude too (both triangle- and sphere-hit points).
            from ceres_tpu.ops import sphere as sphere_ops

            if config.reference_compat:
                tmax_s = jnp.inf
            else:
                # Segment test: nothing beyond the sun can shadow.
                tmax_s = (1.0 / sl_inv) * (1.0 - 1e-4)
            occ_s = sphere_ops.any_hit_cols(point, sun_line, spheres[0],
                                            spheres[1], tmax=tmax_s)
            occluded = occluded | (occ_s & mask)
    else:
        occluded = jnp.zeros_like(mask)

    if config.mode == "smooth":
        shade = shading_mod.smooth_shading_cols(
            sun_line, corner_cols, dir_cols, u_eff, v_eff,
            reference_compat=config.reference_compat)
    elif config.mode == "flat":
        shade = shading_mod.flat_shading_cols(n, guard=mask)
    elif config.mode == "normal":
        # Pure normal visualization (render.hpp:123-125), no lighting.
        shade = shading_mod.flat_shading_cols(n, guard=mask)
        occluded = jnp.zeros_like(occluded)
    else:
        raise ValueError(f"unknown shading mode: {config.mode}")

    lit = mask & ~occluded
    color = tuple(jnp.where(lit, s, 0.0) for s in shade)
    stats = _wavefront_stats(mask, occluded, dir_cols[0].shape[0],
                             soup, config, counts1, counts2)
    return color, stats


def _wavefront_stats(mask, occluded, R, soup, config, counts1, counts2):
    """rays/hits counting parity (render.hpp:102,115,119,138,148)."""
    primary_hits = jnp.sum(mask)
    shadow_hits = jnp.sum(mask & occluded)
    stats = {
        "rays": R + primary_hits,
        "hits": primary_hits + shadow_hits,
        "primary_hits": primary_hits,
        "shadow_hits": shadow_hits,
    }
    if config.traversal_stats:
        if counts1 is not None:
            # Measured inside the kernel (actual loop iterations and gated
            # MT block executions — early exits and skips included), not
            # the scheduled upper bound. SingleRayTraverser::Statistics
            # parity (single_ray_traverser.hpp:131-163).
            zero = {"traversal_steps": jnp.asarray(0), "mt_pairs":
                    jnp.asarray(0), "mt_block_visits": jnp.asarray(0)}
            c2 = counts2 or zero
            stats["traversal_steps"] = (counts1["traversal_steps"]
                                        + c2["traversal_steps"])
            stats["intersections"] = counts1["mt_pairs"] + c2["mt_pairs"]
            stats["mt_block_visits"] = (counts1["mt_block_visits"]
                                        + c2["mt_block_visits"])
        else:
            # Brute force visits no structure: steps 0, R x T pair tests
            # per wavefront (shadow wavefront included when enabled).
            stats["traversal_steps"] = jnp.asarray(0)
            stats["intersections"] = jnp.asarray(
                R * soup.num_triangles * (2 if config.shadows else 1))
    return stats


def render_wavefront(
    soup: TriangleSoup,
    camera: Camera,
    sun_position: jax.Array,
    dirs: jax.Array,  # (R, 3) normalized primary directions from camera.eye
    config: RenderConfig,
    clusters=None,
    spheres=None,
    table_cols=None,
):
    """Render a flat wavefront of primary rays -> ((R, 3) colors, stats).

    The megakernel backend delegates to :func:`render_wavefront_cols`
    (column pipeline); bruteforce keeps the dense (R, 3) form — it is the
    golden oracle path, not a performance path.
    """
    if config.backend == "megakernel":
        cols, stats = render_wavefront_cols(
            soup, camera, sun_position,
            (dirs[:, 0], dirs[:, 1], dirs[:, 2]), config, clusters=clusters,
            spheres=spheres, table_cols=table_cols)
        return jnp.stack(cols, axis=-1), stats

    hit = _closest_primary(soup, camera, dirs, config.backend,
                           clusters=clusters)
    mask = hit.mask
    prim = jax.lax.stop_gradient(jnp.where(hit.mask, hit.prim_id, 0))
    u, v = hit.u, hit.v
    if config.mode == "smooth":
        if soup.corner_normals is None:
            raise ValueError("smooth shading requires corner_normals")
        table = jnp.concatenate(
            [soup.n, soup.corner_normals.reshape(-1, 9)], axis=-1)
        rec = table[prim]
        n = rec[:, :3]
        corners = rec[:, 3:].reshape(-1, 3, 3)
    else:
        n = soup.n[prim]
        corners = None
    # Hit point convention: see render_wavefront_cols.
    if config.reference_compat:
        p0 = soup.p0[prim]
        p1 = p0 - soup.e1[prim]
        p2 = soup.e2[prim] + p0
        w_bar = (1.0 - u - v)[:, None]
        point = u[:, None] * p0 + v[:, None] * p1 + w_bar * p2
    else:
        t_safe = jnp.where(hit.mask, hit.t, 0.0)
        point = camera.eye + t_safe[:, None] * dirs
    point = point + SELF_INTERSECT_OFFSET * _normalize(n)

    if spheres is not None:
        # bvh::Sphere merge (see render_wavefront_cols): the oracle-path
        # dense (R, 3) form of the same closest-t override.
        from ceres_tpu.ops import sphere as sphere_ops

        centers, radii = spheres
        origins = jnp.broadcast_to(camera.eye, dirs.shape)
        sph = sphere_ops.closest_hit(origins, dirs, centers, radii)
        t_tri = jnp.where(mask, hit.t, jnp.inf)
        sph_win = sph.mask & (sph.t < t_tri)
        mask = mask | sph.mask
        st_safe = jnp.where(sph_win, sph.t, 0.0)
        s_point = camera.eye + st_safe[:, None] * dirs
        s_nrm = sphere_ops.normal_at(s_point, centers, sph.sphere_id)
        point = jnp.where(sph_win[:, None],
                          s_point - SELF_INTERSECT_OFFSET * s_nrm, point)
        n = jnp.where(sph_win[:, None], s_nrm, n)
        u = jnp.where(sph_win, 0.0, u)
        v = jnp.where(sph_win, 0.0, v)
        if corners is not None:
            corners = jnp.where(sph_win[:, None, None],
                                s_nrm[:, None, :], corners)
    sun_line = _normalize(sun_position[None, :] - point)

    if config.shadows:
        occluded = _any_shadow(soup, point, sun_line, config.backend,
                               skip=~mask, clusters=clusters)
        if spheres is not None:
            from ceres_tpu.ops import sphere as sphere_ops

            if config.reference_compat:
                tmax_s = jnp.inf
            else:
                dist = jnp.linalg.norm(sun_position[None, :] - point,
                                       axis=-1)
                tmax_s = dist * (1.0 - 1e-4)
            occ_s = sphere_ops.any_hit(point, sun_line, spheres[0],
                                       spheres[1],
                                       tmax=tmax_s if jnp.ndim(tmax_s) == 0
                                       else tmax_s[:, None])
            occluded = occluded | (occ_s & mask)
    else:
        occluded = jnp.zeros(dirs.shape[0], dtype=bool)

    if config.mode == "smooth":
        shade = shading_mod.smooth_shading(
            sun_line, corners, dirs, u, v,
            reference_compat=config.reference_compat)
    elif config.mode == "flat":
        shade = shading_mod.flat_shading(n)
    elif config.mode == "normal":
        shade = shading_mod.flat_shading(n)
        occluded = jnp.zeros_like(occluded)
    else:
        raise ValueError(f"unknown shading mode: {config.mode}")

    lit = mask & ~occluded
    color = jnp.where(lit[:, None], shade, 0.0)
    stats = _wavefront_stats(mask, occluded, dirs.shape[0], soup, config,
                             None, None)
    return color, stats


def render_pipeline(
    vertices: jax.Array,
    faces: jax.Array,
    camera: Camera,
    sun_position: jax.Array,
    config: RenderConfig,
    clusters=None,  # prebuilt ClusterSet for this mesh: skips the per-call
                    # structure build (the reference builds its BVH once
                    # before the frame loop, anim.cpp:62-66)
    spheres=None,   # optional (centers (S, 3), radii (S,)) bvh::Sphere
                    # primitives merged into the scene by closest t
    table_cols=None,  # prebuilt winner table (prepare_winner_table) for
                      # static-geometry frame loops
):
    """Full pipeline from an indexed mesh -> ((H, W, 3) image, stats)."""
    if faces.shape[0] == 0:
        # Clean error like the reference's empty-scene check (anim.cpp:39-42).
        raise ValueError("scene has no triangles")
    soup = triangle_soup(vertices, faces, with_normals=config.mode == "smooth")
    if config.backend == "megakernel":
        # Pixel-block ray order: each 512-ray kernel tile is a compact
        # 16 x 32 screen block, so cluster culling bites (utils.tiling).
        # Column (structure-of-arrays) pipeline end to end.
        from ceres_tpu.models.camera import camera_ray_columns
        from ceres_tpu.utils import tiling

        planes = camera_ray_columns(camera, config.width, config.height)
        dir_cols = tuple(tiling.swizzle_plane(p) for p in planes)
        color, stats = render_wavefront_cols(
            soup, camera, sun_position, dir_cols, config, clusters=clusters,
            spheres=spheres, table_cols=table_cols)
        image = jnp.stack(
            [tiling.unswizzle_plane(c, config.height, config.width)
             for c in color], axis=-1)
        # Padded rays are inert (zero dirs -> no hit) but subtract their
        # count from the traversal stats for reference-parity numbers.
        stats["rays"] = stats["rays"] - (dir_cols[0].shape[0]
                                         - config.height * config.width)
        return image, stats
    dirs_hw = camera_rays(camera, config.width, config.height)
    dirs = dirs_hw.reshape(-1, 3)
    color, stats = render_wavefront(soup, camera, sun_position, dirs, config,
                                    clusters=clusters, spheres=spheres)
    return color.reshape(config.height, config.width, 3), stats


@functools.partial(jax.jit, static_argnames=("config",))
def _render_jit(vertices, faces, camera, sun_position, config, spheres=None,
                clusters=None):
    return render_pipeline(vertices, faces, camera, sun_position, config,
                           spheres=spheres, clusters=clusters)


def render(
    vertices,
    faces,
    camera: Camera,
    sun_position,
    config: Optional[RenderConfig] = None,
    spheres=None,
    clusters=None,
    **kwargs,
):
    """User-facing render call. kwargs override RenderConfig fields.

    Each call builds the acceleration structure for the given mesh. For
    FRAME LOOPS over static geometry, hoist it: call
    render_pipeline with a prebuilt ClusterSet (clusters=...), or use
    the animation / sharded entry points, which hoist the build outside
    their frame loops themselves — the reference's own shape (BVH built
    once before the loop, anim.cpp:62-66).

    Precision follows the input dtype — the reference's one real config
    axis (``Scalar`` float/double, anim.cpp:154-158): pass float64
    vertices (with jax x64 enabled) for a double-precision render. On
    the megakernel backend, float64 runs the ACCELERATED path: winner /
    occlusion search on the f32 walk kernel, with every observable
    value — hit (t, u, v), shading, gradients — recomputed in float64
    at the winners (megakernel._detach_f32). Deviations from an all-f64
    traversal are confined to winner tie-breaks within f32 resolution.
    The bruteforce backend remains the all-f64 oracle (O(R x T)).
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    vertices = jnp.asarray(vertices)
    faces = jnp.asarray(faces)
    sun_position = jnp.asarray(sun_position, vertices.dtype)
    camera = Camera.make(camera.eye, camera.dir, camera.up, camera.fov,
                         dtype=vertices.dtype)
    if spheres is not None:
        centers, radii = spheres
        spheres = (jnp.asarray(centers, vertices.dtype).reshape(-1, 3),
                   jnp.asarray(radii, vertices.dtype).reshape(-1))
    return _render_jit(vertices, faces, camera, sun_position, config,
                       spheres, clusters)
