"""SGM stereo on the PyTorch port against the JAX package, on the CPU.

CPU tensors run each kernel's plain version (ops/sgm_kernel), so these
tests pin the contract the CUDA kernels are held to on the card:
  * census + cost volume (2c) equal to the JAX XLA functions and to the
    Pallas census_cost_pallas in interpret mode (exact integers), also on
    one row, one column, W < D, D = 4, a constant and 8-level images;
  * the horizontal (2d), partial (2e) and total (2f) path sums equal to a
    literal per-pixel recurrence, and aggregate_paths to the JAX scan;
  * 2f's wrapper (P2 120 and 200, a partial of any sign) equal to that
    recurrence summed in int64 and cast to int16, then a per-pixel WTA;
  * the 9 WTA maps (2f) equal to aggregate_wta_pallas in interpret mode;
  * stereo_sgm equal to the JAX fused branch (census_cost_pallas ->
    aggregate_wta_pallas -> _disp_from_wta -> median3 -> lr_consistency,
    interpret mode): disparity within 1e-5, valid masks equal;
  * 3a: against the JAX CPU branch (subpixel right disparity) the left
    disparities agree and the valid masks differ only where the right
    subpixel offset decides the 1 px L/R check.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import sgm as jsgm
from metricsfm_tpu.ops.pallas import sgm_kernel as jk
from metricsfm_tpu_torch.ops import sgm, sgm_kernel
from metricsfm_tpu_torch.utils import synth
from tests.test_sgm_dense import _aggregate_bruteforce
from tests.torch_threads import torch_threads  # noqa: F401


def _images(rng, H, W):
    return (rng.uniform(0, 1, (H, W)).astype(np.float32),
            rng.uniform(0, 1, (H, W)).astype(np.float32))


def _paths_bruteforce(cost, dirs, p1=10, p2=120):
    """Literal per-pixel SGM recurrence summed over the (dy, dx) path
    directions `dirs` (the predecessor of (y, x) is (y - dy, x - dx))."""
    H, W, D = cost.shape
    cost = cost.astype(np.int64)
    total = np.zeros((H, W, D), np.int64)
    for dy, dx in dirs:
        L = np.zeros((H, W, D), np.int64)
        for y in (range(H) if dy >= 0 else range(H - 1, -1, -1)):
            for x in (range(W) if dx >= 0 else range(W - 1, -1, -1)):
                py, px = y - dy, x - dx
                if 0 <= py < H and 0 <= px < W:
                    prev = L[py, px]
                    m = prev.min()
                    best = np.minimum(prev, m + p2)
                    best[1:] = np.minimum(best[1:], prev[:-1] + p1)
                    best[:-1] = np.minimum(best[:-1], prev[1:] + p1)
                    L[y, x] = cost[y, x] + best - m
                else:
                    L[y, x] = cost[y, x]
        total += L
    return total


HORIZONTAL = [(0, 1), (0, -1)]
DOWN = {4: [(1, 0)], 8: [(1, 0), (1, 1), (1, -1)]}
UP = {4: [(-1, 0)], 8: [(-1, 0), (-1, -1), (-1, 1)]}


def test_census_words_match_jax(rng):
    img = rng.uniform(0, 1, (21, 33)).astype(np.float32)
    img[3, 4] = 0.0                  # a zero centre against zero context
    want = np.asarray(jsgm.census_transform(jnp.asarray(img))).astype(np.int64)
    got = sgm.census_transform(torch.tensor(img)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H,W,D", [(19, 29, 24), (13, 37, 48)])
def test_cost_volume_matches_jax_and_pallas(rng, H, W, D):
    """Exact against the XLA volume and the fused Pallas kernel cropped to
    (H, W, D) (interpret mode)."""
    L, R = _images(rng, H, W)
    got = sgm_kernel.census_cost(torch.tensor(L), torch.tensor(R), D)
    assert got.dtype == torch.uint8 and got.shape == (H, W, D)
    got = got.numpy().astype(np.int64)
    want = np.asarray(jsgm.matching_cost_volume(
        jsgm.census_transform(jnp.asarray(L)),
        jsgm.census_transform(jnp.asarray(R)), D)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(jk.census_cost_pallas(jnp.asarray(L), jnp.asarray(R),
                                              D, interpret=True))
    np.testing.assert_array_equal(got, pallas[:H, :W, :D].astype(np.int64))


EDGE_IMAGES = {
    # name: (H, W, D, image maker), the cases 2c's kernel branches on
    "one row": (1, 29, 24, "uniform"),
    "one column": (19, 1, 24, "uniform"),
    "W < D": (7, 12, 24, "uniform"),
    "D = 4": (9, 17, 4, "uniform"),
    "constant": (9, 17, 16, "constant"),
    "8 levels": (11, 23, 20, "levels"),
}


@pytest.mark.parametrize("case", sorted(EDGE_IMAGES))
def test_cost_volume_edge_cases_match_jax_and_pallas(rng, case):
    """2c exact against the XLA volume and the Pallas kernel (interpret
    mode) on one row (no vertical context), one column, W < D, D = 4, a
    constant image and 8-level images (equal neighbours test the strict
    >), with values below 0 and above 1."""
    H, W, D, kind = EDGE_IMAGES[case]
    if kind == "uniform":
        L, R = (rng.uniform(-0.5, 1.5, (H, W)).astype(np.float32)
                for _ in range(2))
    elif kind == "constant":
        L = R = np.full((H, W), 0.5, np.float32)
    else:
        L, R = ((rng.integers(0, 8, (H, W)) / 7).astype(np.float32)
                for _ in range(2))
    got = sgm_kernel.census_cost(torch.tensor(L), torch.tensor(R), D)
    assert got.dtype == torch.uint8 and got.shape == (H, W, D)
    got = got.numpy().astype(np.int64)
    want = np.asarray(jsgm.matching_cost_volume(
        jsgm.census_transform(jnp.asarray(L)),
        jsgm.census_transform(jnp.asarray(R)), D)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(jk.census_cost_pallas(jnp.asarray(L), jnp.asarray(R),
                                              D, interpret=True))
    np.testing.assert_array_equal(got, pallas[:H, :W, :D].astype(np.int64))


@pytest.mark.parametrize("num_paths", [4, 8])
def test_aggregate_paths_matches_jax_and_bruteforce(rng, num_paths):
    cost = rng.integers(0, 64, size=(10, 12, 8))
    want = _aggregate_bruteforce(cost.astype(np.int16), num_paths=num_paths)
    got = sgm.aggregate_paths(torch.tensor(cost.astype(np.uint8)),
                              num_paths=num_paths)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    jax_agg = np.asarray(jsgm.aggregate_paths(
        jnp.asarray(cost.astype(np.int16)), num_paths=num_paths))
    np.testing.assert_array_equal(got.numpy(), jax_agg)


@pytest.mark.parametrize("p1,p2", [(7, 90), (10, 200)])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_stage_sums_match_bruteforce(rng, num_paths, p1, p2):
    """2d = the two horizontal paths, 2e = 2d + the down paths, and the
    total inside 2f = 2e + the up paths, each with P1/P2 other than the
    defaults and a ragged D; P2 = 200 is where the kernels' single-path
    scratch volumes are int16.  Tolerance 0: integers."""
    cost = rng.integers(0, 65, size=(9, 11, 7))
    c = torch.tensor(cost.astype(np.uint8))
    h = sgm_kernel.sgm_horizontal(c, p1, p2)
    np.testing.assert_array_equal(
        h.numpy(), _paths_bruteforce(cost, HORIZONTAL, p1, p2))
    part = sgm_kernel.sgm_partial(c, h, p1, p2, num_paths)
    np.testing.assert_array_equal(
        part.numpy(),
        _paths_bruteforce(cost, HORIZONTAL + DOWN[num_paths], p1, p2))
    tot = sgm_kernel.total_reference(c, part, p1, p2, num_paths)
    np.testing.assert_array_equal(
        tot.numpy(), _paths_bruteforce(
            cost, HORIZONTAL + DOWN[num_paths] + UP[num_paths], p1, p2))


@pytest.mark.parametrize("p2", [0, 90, 120, 191, 192, 200, 4031])
def test_scratch_dtype_holds_every_single_path_value(p2):
    """The rule that picks the kernels' scratch type gives uint8 exactly
    when 64 + P2 <= 255, and the plain recurrence never goes above 64 + P2
    on adversarial costs (runs of 0 and 64 along the path, so that one
    disparity leads by P2 and the rest pay 64 on top of it); it reaches
    the bound, so the rule has no slack.  Tolerance 0."""
    st = sgm_kernel.scratch_dtype(p2)
    assert st == (torch.uint8 if 64 + p2 <= 255 else torch.int16)
    rng = np.random.default_rng(p2)
    N, D = 72, 16
    cost = np.full((N, N, D), 64, np.int64)
    cost[:66, :, 0] = 0            # 66 steps with one free disparity
    for n0 in range(66, N, 2):     # then runs of 2 steps
        for m in range(N):
            if rng.uniform() < 0.7:    # one free disparity
                cost[n0:n0 + 2, m, rng.integers(D)] = 0
            if rng.uniform() < 0.3:    # all zero
                cost[n0:n0 + 2, m] = 0
    c = torch.tensor(cost.astype(np.uint8))
    # P1 >= P2: a neighbour's +P1 cannot undercut m + P2, so the value at
    # a disparity far from the free one climbs by 64 a step to 64 + P2
    p1 = max(10, p2)
    for reverse, shift in ((False, 0), (True, 0), (False, 1), (True, -1)):
        L = sgm_kernel._scan(c, reverse, (shift,), p1, p2)
        assert int(L.max()) == 64 + p2
        assert int(L.min()) >= 0
        assert torch.equal(L.to(st).to(torch.int32), L)


def _wrap16(x):
    """An int64 sum cast to int16, wrapping as the int32 add does."""
    return ((x + 32768) % 65536 - 32768).astype(np.int16)


def _partial_input(rng, cost, p1, p2, num_paths, signed):
    """2f / 2g's input: the plain stage sum 2d + 2e, or int16 of any sign
    (a caller's partial that wraps)."""
    if signed:
        return rng.integers(-32768, 32768, size=cost.shape).astype(np.int16)
    return _paths_bruteforce(cost, HORIZONTAL + DOWN[num_paths], p1,
                             p2).astype(np.int16)


def _wta_bruteforce(total):
    """The nine WTA maps of an (H, W, D) total, pixel by pixel: left c0,
    best (first d), c1 over |d - best| > 1 capped at 16000, cm/cc/cp;
    right the same c0/best/c1 over total(x + d, d), 30000 past W."""
    H, W, D = total.shape
    t = total.astype(np.int64)
    out = {k: np.zeros((H, W), np.int64) for k in (
        "c0", "best", "c1", "cm", "cc", "cp", "r0", "rbest", "r1")}
    d = np.arange(D)
    for y in range(H):
        for x in range(W):
            for side, v in (("", t[y, x]), ("r", np.array(
                    [t[y, x + e, e] if x + e < W else 30000
                     for e in range(D)]))):
                best = int(np.argmin(v))
                far = np.abs(d - best) > 1
                c1 = min(16000, int(v[far].min())) if far.any() else 16000
                if side:
                    out["r0"][y, x], out["rbest"][y, x] = v[best], best
                    out["r1"][y, x] = c1
                else:
                    bm = min(max(best, 1), D - 2)
                    out["c0"][y, x], out["best"][y, x] = v[best], best
                    out["c1"][y, x] = c1
                    out["cm"][y, x], out["cc"][y, x], out["cp"][y, x] = \
                        v[bm - 1], v[bm], v[bm + 1]
    return out


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("p2", [120, 200])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_total_wta_wrapper_matches_bruteforce(rng, num_paths, p2, signed):
    """Kernel 2f's wrapper on the CPU: the up paths onto the partial sum
    (the plain 2d + 2e, or int16 of any sign), summed in int64 and cast
    to int16, then the nine maps pixel by pixel; P2 = 200 is where the
    card's single-path scratch volumes are int16.  Tolerance 0."""
    cost = rng.integers(0, 65, size=(9, 11, 7))
    part = _partial_input(rng, cost, 10, p2, num_paths, signed)
    total = _wrap16(part.astype(np.int64) + _paths_bruteforce(
        cost, UP[num_paths], 10, p2))
    want = _wta_bruteforce(total)
    tl, tr = sgm_kernel.sgm_total_wta(torch.tensor(cost.astype(np.uint8)),
                                      torch.tensor(part), 10, p2, num_paths)
    got = {**tl, "r0": tr["c0"], "rbest": tr["best"], "r1": tr["c1"]}
    for k, v in want.items():
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _wta_vs_pallas(jl, jr, tl, tr):
    for k in sgm_kernel.WTA_LEFT:
        np.testing.assert_array_equal(tl[k].numpy(),
                                      np.asarray(jl[k]).astype(np.int64),
                                      err_msg=f"left {k}")
    for k in sgm_kernel.WTA_RIGHT:
        np.testing.assert_array_equal(tr[k].numpy(),
                                      np.asarray(jr[k]).astype(np.int64),
                                      err_msg=f"right {k}")


@pytest.mark.parametrize("H,W,D", [(24, 40, 16), (13, 29, 37)])
def test_wta_maps_match_pallas(rng, H, W, D):
    """The 9 integer maps of kernel 2f against aggregate_wta_pallas
    (interpret, f32 storage): exact."""
    cost = rng.integers(0, 64, size=(H, W, D))
    jl, jr = jk.aggregate_wta_pallas(jnp.asarray(cost.astype(np.float32)),
                                     10, 120, 8, interpret=True,
                                     storage=jnp.float32)
    c = torch.tensor(cost.astype(np.uint8))
    part = sgm_kernel.sgm_partial(c, sgm_kernel.sgm_horizontal(c))
    tl, tr = sgm_kernel.sgm_total_wta(c, part)
    assert all(v.dtype == torch.int32 and v.shape == (H, W)
               for v in list(tl.values()) + list(tr.values()))
    _wta_vs_pallas(jl, jr, tl, tr)


def _jax_fused(L, R, D, num_paths=8):
    """The JAX package's fused accelerator branch of stereo_sgm
    (metricsfm_tpu/ops/sgm.py:362-394), Pallas in interpret mode."""
    H, W = L.shape
    cp = jk.census_cost_pallas(jnp.asarray(L), jnp.asarray(R), D,
                               packed=True, interpret=True)
    wl, wr = jk.aggregate_wta_pallas(cp, 10, 120, num_paths, packed=True,
                                     real_shape=(H, W, D), interpret=True)
    dl, ul = jsgm._disp_from_wta(wl, D, 0.96, True)
    dr, _ = jsgm._disp_from_wta(wr, D, 0.96, False)
    dl, dr = jsgm.median3(dl), jsgm.median3(dr)
    valid = ul & jsgm.lr_consistency(dl, dr)
    return wl, wr, np.asarray(jnp.where(valid, dl, -1.0)), np.asarray(valid)


def test_stereo_sgm_matches_jax_fused_branch():
    L, R, _ = synth.stereo_pair(np.random.default_rng(1), H=48, W=64,
                                disp_bg=3, disp_fg=9)
    D = 16
    jl, jr, jdisp, jvalid = _jax_fused(L, R, D)
    tL, tR = torch.tensor(L), torch.tensor(R)
    c = sgm_kernel.census_cost(tL, tR, D)
    tl, tr = sgm_kernel.sgm_total_wta(
        c, sgm_kernel.sgm_partial(c, sgm_kernel.sgm_horizontal(c)))
    _wta_vs_pallas(jl, jr, tl, tr)
    disp, valid = sgm.stereo_sgm(tL, tR, max_disp=D)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_allclose(disp.numpy(), jdisp, atol=1e-5, rtol=0)
    assert 0.5 < valid.numpy().mean()


def test_3a_right_subpixel_only_moves_the_lr_check():
    """3a, settled: the port's right disparity is the fused branch's
    integer WTA; the JAX CPU branch takes it with subpixel.  Left
    disparities agree wherever both are valid, and every pixel whose
    validity differs is one where the integer and the subpixel right
    disparity give different answers to the 1 px L/R check.  On this
    64x96 / D=16 scene that is 0.13 % of the pixels (8 of 6,144)."""
    L, R, _ = synth.stereo_pair(np.random.default_rng(2), H=64, W=96,
                                disp_bg=4, disp_fg=10)
    D = 16
    jdisp, jvalid = jsgm.stereo_sgm(jnp.asarray(L), jnp.asarray(R),
                                    max_disp=D)
    jdisp, jvalid = np.asarray(jdisp), np.asarray(jvalid)
    tL, tR = torch.tensor(L), torch.tensor(R)
    disp, valid = sgm.stereo_sgm(tL, tR, max_disp=D)
    disp, valid = disp.numpy(), valid.numpy()
    both = valid & jvalid
    np.testing.assert_allclose(disp[both], jdisp[both], atol=1e-5, rtol=0)

    # the two L/R checks, from the port's own pieces
    agg = sgm.aggregate_paths(sgm_kernel.census_cost(tL, tR, D))
    dl, uniq = sgm.winner_takes_all(agg)
    dl = sgm.median3(dl)
    tl, tr = sgm_kernel.wta_maps_reference(agg)
    dr_int = sgm.median3(sgm._disp_from_wta(tr, D, 0.96, False)[0])
    H, W = L.shape
    cost_r = torch.full((H, W, D), 30000, dtype=torch.int16)
    for d in range(D):
        cost_r[:, :W - d, d] = agg[:, d:, d]
    dr_sub = sgm.median3(sgm.winner_takes_all(cost_r)[0])
    lr_int = (uniq & sgm.lr_consistency(dl, dr_int)).numpy()
    lr_sub = (uniq & sgm.lr_consistency(dl, dr_sub)).numpy()
    np.testing.assert_array_equal(lr_int, valid)
    np.testing.assert_array_equal(lr_sub, jvalid)
    differ = valid != jvalid
    assert (lr_int != lr_sub)[differ].all()
    assert differ.sum() == 11, differ.sum()


def test_winner_takes_all_matches_jax(rng):
    for dtype in (np.int16, np.float32):
        agg = rng.integers(0, 400, size=(9, 13, 12)).astype(dtype)
        for sub in (True, False):
            jd, jv = jsgm.winner_takes_all(jnp.asarray(agg), 0.96, sub)
            d, v = sgm.winner_takes_all(torch.tensor(agg), 0.96, sub)
            np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_tail_ops_match_jax(rng):
    x = rng.uniform(0, 20, (17, 23)).astype(np.float32)
    y = rng.uniform(0, 20, (17, 23)).astype(np.float32)
    x[2, :6] = [0.5, 1.5, 2.5, 3.5, 4.5, 5.5]      # round half to even
    np.testing.assert_array_equal(sgm.median3(torch.tensor(x)).numpy(),
                                  np.asarray(jsgm.median3(jnp.asarray(x))))
    np.testing.assert_array_equal(
        sgm.lr_consistency(torch.tensor(x), torch.tensor(y)).numpy(),
        np.asarray(jsgm.lr_consistency(jnp.asarray(x), jnp.asarray(y))))
    disp = x - 3.0
    depth = sgm.disparity_to_depth(torch.tensor(disp), 80.0, 0.5)
    jdepth = np.asarray(jsgm.disparity_to_depth(jnp.asarray(disp), 80.0, 0.5))
    np.testing.assert_allclose(depth.numpy(), jdepth, rtol=1e-6, atol=0)
    K_inv = np.linalg.inv(np.array([[80.0, 0, 11], [0, 80.0, 8], [0, 0, 1]]))
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.2, -0.1, 0.4])
    f32 = [a.astype(np.float32) for a in (K_inv, R, t)]
    Xw, m = sgm.depth_to_points(depth, *map(torch.tensor, f32), stride=2)
    jX, jm = jsgm.depth_to_points(jnp.asarray(jdepth),
                                  *map(jnp.asarray, f32), stride=2)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(Xw.numpy(), np.asarray(jX), rtol=1e-5,
                               atol=1e-3)


def test_wrappers_check_arguments():
    """Wrong types and devices raise; CPU calls count no kernel launch."""
    c = torch.zeros((4, 5, 8), dtype=torch.uint8)
    sgm_kernel.reset_launches()
    with pytest.raises(TypeError):
        sgm_kernel.sgm_horizontal(c.to(torch.int16))
    with pytest.raises(ValueError):
        sgm_kernel.sgm_horizontal(c[:, :, :3].contiguous())
    with pytest.raises(ValueError):
        sgm_kernel.sgm_horizontal(c.transpose(0, 1))
    with pytest.raises(ValueError):
        sgm_kernel.sgm_horizontal(c.to("meta"))
    with pytest.raises(ValueError):
        sgm_kernel.sgm_partial(c, torch.zeros((4, 5, 7), dtype=torch.int16))
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total_wta(c, torch.zeros((4, 5, 8),
                                                dtype=torch.int16),
                                 num_paths=6)
    with pytest.raises(ValueError):
        sgm_kernel.sgm_horizontal(c, 10, 4032)      # 8 x (64 + P2) > int16
    part = torch.zeros((4, 5, 8), dtype=torch.int16)
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total_wta(c, part, 10, 4032)
    with pytest.raises(TypeError):
        sgm_kernel.sgm_total_wta(c, part.to(torch.int32))
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total_wta(c, part[:, :4].contiguous())
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total_wta(c.to("meta"), part.to("meta"))
    with pytest.raises(ValueError):
        sgm_kernel.scratch_dtype(-1)
    with pytest.raises(TypeError):
        sgm_kernel.census_cost(torch.zeros(4, 5, dtype=torch.float64),
                               torch.zeros(4, 5, dtype=torch.float64), 8)
    h = sgm_kernel.sgm_horizontal(c)
    sgm_kernel.sgm_total_wta(c, sgm_kernel.sgm_partial(c, h))
    assert all(k.launches == 0 for k in sgm_kernel.KERNELS)
