"""The walk kernel (Pallas, Triton route): interpreted here, compiled on
the card.

On the CPU the kernel runs in the Pallas interpreter and is checked
against the plain-JAX walk (ops/walk_f64.py in float32) in every mode,
flat and two-level; its Triton lowering is checked by lowering it for
CUDA. Tests marked ``gpu`` run the compiled kernel on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ceres_tpu.accel import clusters as cl
from ceres_tpu.models.mesh import triangle_soup
from ceres_tpu.ops import megakernel as mk
from ceres_tpu.ops import walk_f64 as plain


def _scene(rng, V=200, F=400):
    verts = rng.standard_normal((V, 3)).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                         with_normals=False)
    return soup, cl.build_clusters_treelet(soup)


def _dirs(rng, R):
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tuple(jnp.asarray(d[:, a]) for a in range(3))


def _run(mode, soup, cs, rng, window=False, R=700):
    """(kernel out, plain-walk out, kernel counters) for one mode."""
    dirs = _dirs(rng, R)
    if mode == "closest":
        eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
        win = {}
        if window:
            tmin = jnp.asarray(rng.uniform(0.0, 3.0, R).astype(np.float32))
            win = dict(tmin=tmin, tmax=tmin + 2.0)
        k, cnt = mk._closest_search(cs, eye, dirs, **win)
        p, _ = plain.closest_search(cs, eye, dirs, **win)
        return np.asarray(k), np.asarray(p), cnt
    skip = jnp.asarray(rng.random(R) < 0.3)
    center = jnp.mean(soup.p0, axis=0)
    seg = mode != "any"
    if mode == "any_seg_far":
        # The renderer's shadow wavefront: receivers inside the soup,
        # segments to a light ~20 scene radii away.
        org = tuple(0.2 * c for c in dirs)
        light = (30.0, 45.0, -20.0)
        dirs = tuple(light[a] - org[a] for a in range(3))
    else:
        org = tuple(jnp.asarray(rng.standard_normal(R).astype(np.float32)
                                * 0.1 + o) for o in (0.0, 0.0, -4.0))
    if mode == "any_seg":   # segments of length 0..8: some end in the soup
        dirs = tuple(c * jnp.asarray(rng.uniform(0, 8, R), jnp.float32)
                     for c in dirs)
    k, cnt = mk.any_hit(soup, center, org, dirs, skip=skip, clusters=cs,
                        with_counts=True, segment=seg)
    p, _ = plain.any_hit(cs, center, org, dirs, skip=skip, segment=seg)
    return np.asarray(k), np.asarray(p), cnt


@pytest.mark.parametrize("mode,hier,window", [
    ("closest", False, False), ("closest", True, False),
    ("closest", False, True), ("closest", True, True),
    ("any", False, False), ("any", True, False),
    ("any_seg", False, False), ("any_seg", True, False),
    ("any_seg_far", False, False), ("any_seg_far", True, False),
])
def test_kernel_matches_plain_walk(rng, monkeypatch, mode, hier, window):
    """Interpreted kernel vs the plain-JAX walk in float32, every mode."""
    soup, cs = _scene(rng)
    if hier:
        monkeypatch.setattr(mk, "_HIER_MIN_CLUSTERS", 1)
    k, p, _ = _run(mode, soup, cs, np.random.default_rng(1), window)
    if mode == "closest":
        np.testing.assert_array_equal(k >= 0, p >= 0)
        both = (k >= 0) & (p >= 0)
        # Winner keys clear low mantissa bits: near-ties may pick another
        # triangle (the documented tie-break), nothing else may differ.
        assert (k[both] == p[both]).mean() > 0.99
    else:
        np.testing.assert_array_equal(k, p)


@pytest.mark.parametrize("hier", [False, True])
def test_tile_visits_sum_to_traversal_steps(rng, monkeypatch, hier):
    """steps is per tile; the counters the callers report are its sum."""
    soup, cs = _scene(rng)
    if hier:
        monkeypatch.setattr(mk, "_HIER_MIN_CLUSTERS", 1)
    eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
    dirs = _dirs(np.random.default_rng(2), 3 * mk.TILE - 5)
    _, cnt = mk._closest_search(cs, eye, dirs)
    captured = {}
    orig = mk._walk_pallas

    def spy(*a, **kw):
        out, steps = orig(*a, **kw)
        captured["steps"] = steps
        return out, steps

    monkeypatch.setattr(mk, "_walk_pallas", spy)
    mk._closest_search(cs, eye, dirs)
    steps = np.asarray(captured["steps"])
    assert steps.shape == (3,)                  # one slot per tile
    assert (steps >= 0).all()
    assert int(steps.sum()) == int(cnt["traversal_steps"])
    assert int(cnt["traversal_steps"]) > 0


@pytest.mark.parametrize("platform,interpret", [
    ("gpu", False), ("cpu", True), ("rocm", None), ("metal", None),
])
def test_walk_kernel_choice(platform, interpret):
    """Compiled on the GPU, interpreted only on the CPU, nowhere else."""
    if interpret is None:
        with pytest.raises(ValueError, match="walk kernel"):
            mk._walk_interpret(platform)
    else:
        assert mk._walk_interpret(platform) is interpret


def test_walk_kernel_choice_default_backend():
    assert mk._walk_interpret() is (jax.default_backend() == "cpu")


@pytest.mark.parametrize("chunk", [2, 4])
def test_register_chunks_match_whole_cluster(rng, chunk):
    """The chunked triangle loop (the compiled default) gives the same
    winners and visits as one whole-cluster step."""
    soup, cs = _scene(rng)
    eye = jnp.asarray([0.0, 0.0, -4.0], jnp.float32)
    dirs = _dirs(np.random.default_rng(3), 600)
    w = cl.cluster_weights_common_origin_packed(cs, eye)
    dp = tuple(mk._pad_rays(c) for c in dirs)
    tiled = tuple(c.reshape(-1, mk.TILE) for c in dp)
    root_lo, root_hi = mk._scene_root(cs)
    tcap = mk._ray_tcap(root_lo - eye, root_hi - eye, None, dp)
    feats = mk._feats_from_cols(dp, w.shape[1], tcap=tcap)
    keys, counts = mk._tile_candidate_keys(cs.lo - eye, cs.hi - eye, tiled)
    runs = [mk._walk_pallas(counts, keys, feats, w, K=4, mode="closest",
                            interpret=True, chunk=c)
            for c in (chunk, cs.cluster_size)]
    np.testing.assert_array_equal(np.asarray(runs[0][0]),
                                  np.asarray(runs[1][0]))
    np.testing.assert_array_equal(np.asarray(runs[0][1]),
                                  np.asarray(runs[1][1]))


@pytest.mark.parametrize("K", [4, 10])
def test_packed_weights_zero_outside_mt_rows(rng, K):
    """The kernel forms only the _MT_ROWS products: every other packed
    weight row of each channel must be zero."""
    soup, cs = _scene(rng)
    o = jnp.asarray([0.3, -0.2, 0.1], jnp.float32)
    w = np.asarray(cl.cluster_weights_common_origin_packed(cs, o) if K == 4
                   else cl.cluster_weights_generic_packed(cs, o))
    C = cs.cluster_size
    for ch, rows in enumerate(mk._MT_ROWS[K]):
        off = [k for k in range(w.shape[1]) if k not in rows]
        assert not w[:, off, ch * C:(ch + 1) * C].any()


@pytest.mark.parametrize("mode,S,window", [
    ("closest", 1, False), ("closest", 1, True), ("closest", 16, False),
    ("closest", 16, True), ("any", 1, False), ("any", 16, False),
    ("any_seg", 1, False), ("any_seg", 8, False),
    ("closest", 32, True), ("any_seg", 32, False),
])
def test_kernel_lowers_to_triton(mode, S, window):
    """Lower the compiled (not interpreted) kernel for CUDA: the Pallas
    Triton lowering runs in Python, so every rule the kernel needs (block
    sizes, loads, loops, reductions) is checked without the card."""
    K = 4 if mode == "closest" else 10
    Kp = 16 if K == 10 else 8
    n_t, R, C, n_c = 3, mk.TILE, 128, 40
    n_blocks = n_c * S + (S if S > 1 else 0)
    args = [jnp.zeros((n_t,), jnp.int32), jnp.zeros((n_t, n_c), jnp.int32),
            jnp.zeros((Kp, n_t * R), jnp.float32),
            jnp.zeros((n_blocks, Kp, 4 * C), jnp.float32),
            None if mode == "closest" else jnp.zeros((n_t * R,), jnp.int32)]
    if S > 1:
        args += [jnp.zeros((n_t, 16), jnp.float32),
                 jnp.zeros((n_c, 8, S), jnp.float32),
                 jnp.zeros((n_c,), jnp.int32)]

    def f(*a):
        return mk._walk_pallas(*a, K=K, mode=mode, interpret=False, S=S,
                               window=window)

    text = jax.jit(f).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "ceres_walk" in text


@pytest.mark.parametrize("exact", [False, True])
def test_segment_stops_at_its_end(exact):
    """segment=True: an occluder between origin and end shadows, one past
    the end does not (the shadow query toward a point light)."""
    import contextlib

    with jax.enable_x64() if exact else contextlib.nullcontext():
        _segment_case(jnp.float64 if exact else jnp.float32, exact)


def _segment_case(dt, exact):
    def soup_at(y):
        tri = np.asarray([[-1, y, -1], [1, y, -1], [0, y, 1]], np.float64)
        return triangle_soup(jnp.asarray(tri, dt),
                             jnp.asarray([[0, 1, 2]], jnp.int32),
                             with_normals=False)

    origin = (jnp.zeros(1, dt),) * 3
    seg = (jnp.zeros(1, dt), jnp.full((1,), 5.0, dt), jnp.zeros(1, dt))
    for y, want in ((2.0, True), (10.0, False)):
        soup = soup_at(y)
        occ = mk.any_hit(soup, jnp.zeros(3, dt), origin, seg,
                         segment=True, exact_f64=exact)
        assert bool(np.asarray(occ)[0]) is want
        # Without the segment bound the far occluder shadows too.
        assert bool(np.asarray(mk.any_hit(soup, jnp.zeros(3, dt), origin,
                                          seg, exact_f64=exact))[0])


def test_exact_f64_walk_rejects_f32_clusters(rng):
    """The exact mode searches in the ClusterSet's dtype: a float32 one
    must be refused, not silently searched in float32."""
    _, cs = _scene(rng)
    dirs = _dirs(rng, 8)
    with pytest.raises(ValueError, match="float64 ClusterSet"):
        plain.closest_search_f64(cs, jnp.zeros(3), dirs)
    with pytest.raises(ValueError, match="float64 ClusterSet"):
        plain.any_hit_f64(cs, jnp.zeros(3), dirs, dirs)


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return found


def test_sphere_winner_gather_is_full_f32():
    """The one-hot sphere winner gather is pinned to HIGHEST (no TF32)."""
    from ceres_tpu.ops import sphere

    eye = jnp.zeros(3, jnp.float32)
    dirs = tuple(jnp.ones((16,), jnp.float32) * v for v in (0.0, 0.0, 1.0))
    centers = jnp.asarray([[0.0, 0.0, 5.0], [0.1, 0.0, 9.0]], jnp.float32)
    radii = jnp.asarray([1.0, 0.5], jnp.float32)
    precs = _dot_precisions(sphere.closest_hit_common_origin_cols, eye,
                            dirs, centers, radii)
    assert len(precs) == 4
    hi = jax.lax.Precision.HIGHEST
    assert all(p in (hi, (hi, hi)) for p in precs), precs


def test_plain_walk_products_are_full_f32(rng):
    """The plain walk's einsums are pinned to HIGHEST, so its float32 run
    is a true-f32 reference for the kernel."""
    _, cs = _scene(rng, F=200)
    dirs = _dirs(rng, 64)
    precs = _dot_precisions(
        lambda c, d: plain.closest_search(c, jnp.zeros(3), d), cs, dirs)
    hi = jax.lax.Precision.HIGHEST
    assert precs and all(p in (hi, (hi, hi)) for p in precs), precs


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["closest", "any", "any_seg_far"])
def test_compiled_kernel_matches_interpreted(gpu, rng, mode):
    """On the card: the compiled Triton kernel against the same kernel in
    the interpreter, flat and two-level."""
    soup, cs = _scene(rng)
    for hier in (False, True):
        saved = mk._HIER_MIN_CLUSTERS
        mk._HIER_MIN_CLUSTERS = 1 if hier else saved
        try:
            k, p, _ = _run(mode, soup, cs, np.random.default_rng(4))
            orig = mk._walk_interpret
            mk._walk_interpret = lambda platform=None: True
            try:
                ki, _, _ = _run(mode, soup, cs, np.random.default_rng(4))
            finally:
                mk._walk_interpret = orig
        finally:
            mk._HIER_MIN_CLUSTERS = saved
        if mode == "closest":
            np.testing.assert_array_equal(k >= 0, ki >= 0)
            assert (k == ki).mean() > 0.99
        else:
            assert (k == ki).mean() > 0.99


@pytest.mark.gpu
def test_walk_is_compiled_on_gpu(gpu):
    assert mk._walk_interpret() is False
