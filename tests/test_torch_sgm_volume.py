"""The SGM volume path of the PyTorch port against the JAX package, on the
CPU: kernels 2g (sgm_total, also against the literal recurrence at P2
120 and 200 and on a partial of any sign) and 2h (wta, also against a
per-pixel brute force on int16 extremes, int32 beyond 2^24 and float32
+-0.0 ties), `aggregate_paths` and
`winner_takes_all` through them, and `stereo_sgm_volume` against the JAX
stereo_sgm branch that writes the summed volume (the one it runs on the
CPU).  CPU tensors run each kernel's plain version; the Pallas kernels run
in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import sgm as jsgm
from metricsfm_tpu.ops.pallas import sgm_kernel as jk
from metricsfm_tpu_torch.ops import sgm, sgm_kernel
from metricsfm_tpu_torch.utils import synth
from tests.test_torch_sgm import (DOWN, HORIZONTAL, UP, _partial_input,
                                  _paths_bruteforce, _wrap16)
from tests.torch_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("num_paths", [4, 8])
def test_sgm_total_matches_pallas_and_bruteforce(rng, num_paths):
    """2g on 2d/2e's outputs equals aggregate_paths_pallas (interpret,
    int16 storage) and the literal recurrence, exactly, at a ragged
    shape."""
    H, W, D = 13, 37, 48
    cost = rng.integers(0, 65, size=(H, W, D))
    c = torch.tensor(cost.astype(np.uint8))
    part = sgm_kernel.sgm_partial(c, sgm_kernel.sgm_horizontal(c),
                                  num_paths=num_paths)
    total = sgm_kernel.sgm_total(c, part, num_paths=num_paths)
    assert total.dtype == torch.int16 and total.shape == (H, W, D)
    want = np.asarray(jk.aggregate_paths_pallas(
        jnp.asarray(cost.astype(np.int16)), 10, 120, num_paths,
        interpret=True, storage=jnp.int16))
    np.testing.assert_array_equal(total.numpy(), want)
    np.testing.assert_array_equal(
        total.numpy(), _paths_bruteforce(
            cost, HORIZONTAL + DOWN[num_paths] + UP[num_paths]))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("p2", [120, 200])
@pytest.mark.parametrize("num_paths", [4, 8])
def test_sgm_total_wrapper_matches_bruteforce(rng, num_paths, p2, signed):
    """2g's wrapper on the CPU: the up paths onto the partial sum (the
    plain 2d + 2e, or int16 of any sign), against the literal recurrence
    summed in int64 and cast to int16; P2 = 200 is where the card's
    single-path scratch volumes are int16.  Tolerance 0."""
    cost = rng.integers(0, 65, size=(9, 11, 7))
    part = _partial_input(rng, cost, 10, p2, num_paths, signed)
    want = _wrap16(part.astype(np.int64) + _paths_bruteforce(
        cost, UP[num_paths], 10, p2))
    got = sgm_kernel.sgm_total(torch.tensor(cost.astype(np.uint8)),
                               torch.tensor(part), 10, p2, num_paths)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D,hi", [(16, 7999), (37, 7999), (37, 12)])
def test_wta_matches_pallas(rng, D, hi):
    """2h's six maps equal wta_pallas (interpret) on int16 volumes with
    values below 8000, where the Pallas 8000-valued pads and its 16000 cap
    never bind; hi = 12 makes ties common (they go to the smallest d)."""
    vol = rng.integers(0, hi + 1, size=(11, 19, D)).astype(np.int16)
    got = sgm_kernel.wta(torch.tensor(vol), 16000)
    want = jk.wta_pallas(jnp.asarray(vol), interpret=True)
    assert set(got) == set(sgm_kernel.WTA_LEFT)
    for k in sgm_kernel.WTA_LEFT:
        assert got[k].dtype == torch.int32 and got[k].shape == (11, 19)
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)


def _wta_bruteforce(vol, cap):
    """The six WTA_LEFT maps of an (H, W, D) volume, pixel by pixel."""
    H, W, D = vol.shape
    out = {k: np.zeros((H, W), np.float64) for k in sgm_kernel.WTA_LEFT}
    for y in range(H):
        for x in range(W):
            v = [float(t) for t in vol[y, x]]
            best = min(range(D), key=lambda d: (v[d], d))
            bm = min(max(best, 1), D - 2)
            far = [v[d] for d in range(D) if abs(d - best) > 1]
            for k, val in (("c0", v[best]), ("best", best),
                           ("c1", min([cap] + far)), ("cm", v[bm - 1]),
                           ("cc", v[bm]), ("cp", v[bm + 1])):
                out[k][y, x] = val
    return out


def _wta_volume(rng, kind, D):
    H, W = 5, 7
    if kind == "int16 extremes":
        v = rng.integers(-32768, 32768, (H, W, D))
        v[0, 0] = 7                            # flat: best 0, c1 = c0
        v[0, 1] = -32768
        v[0, 2] = 32767
        v[1, :, 0] = -32768                    # best at 0
        v[2, :, D - 1] = -32768                # best at D - 1
        v[3] = rng.integers(0, 3, (W, D))      # ties
        return v.astype(np.int16), 30000
    if kind == "int32 beyond 2^24":
        v = rng.integers(-2 ** 30, 2 ** 30, (H, W, D))
        v[0, :, ::3] = -2 ** 29 - 1            # ties
        v[1] = rng.integers(0, 3, (W, D)) * 2 ** 25 + 1
        return v.astype(np.int32), 10 ** 9
    v = (rng.integers(-3, 4, (H, W, D)) * 3.0e7).astype(np.float32)
    v[v == 0] = -0.0
    v[0, :, ::2] = 0.0                         # +0.0 / -0.0 ties
    v[0, :, 1::2] = -0.0
    v[1] = rng.uniform(-1, 1, (W, D))
    return v, 1e9


@pytest.mark.parametrize("D", [4, 37])
@pytest.mark.parametrize("kind", ["int16 extremes", "int32 beyond 2^24",
                                  "float32 +-0.0 ties"])
def test_wta_matches_bruteforce(rng, kind, D):
    """2h exactly equal to the per-pixel definition: c0 the minimum, best
    the smallest d reaching it (+0.0 and -0.0 tie), c1 the capped minimum
    over |d - best| > 1, cm / cc / cp at clip(best, 1, D - 2) -1 / 0 / +1."""
    vol, cap = _wta_volume(rng, kind, D)
    got = sgm_kernel.wta(torch.tensor(vol), cap)
    want = _wta_bruteforce(vol, cap)
    for k in sgm_kernel.WTA_LEFT:
        np.testing.assert_array_equal(got[k].numpy().astype(np.float64),
                                      want[k], err_msg=k)


def test_wta_dtypes():
    """int16 / int32 volumes give int32 maps; float32 gives float32 maps
    with an int32 best; c1 is capped at c1_cap."""
    vol = torch.arange(2 * 3 * 6, dtype=torch.int32).reshape(2, 3, 6) + 10
    for dt in (torch.int16, torch.int32):
        w = sgm_kernel.wta(vol.to(dt), 5)
        assert all(v.dtype == torch.int32 for v in w.values())
        assert (w["best"] == 0).all() and (w["c1"] == 5).all()
    w = sgm_kernel.wta(vol.float() * 0.5, 1e9)
    assert w["best"].dtype == torch.int32
    assert all(w[k].dtype == torch.float32 for k in ("c0", "c1", "cm",
                                                        "cc", "cp"))
    np.testing.assert_array_equal(w["c1"].numpy(), w["c0"].numpy() + 1.0)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_winner_takes_all_through_2h_matches_jax(rng, dtype):
    """winner_takes_all (2h + the torch tail) against the JAX volume WTA:
    disparity within 1e-5, valid masks equal, with and without subpixel,
    at a ragged D with ties."""
    agg = rng.integers(0, 90, size=(9, 14, 23)).astype(dtype)
    agg[0, 0] = 7                      # a flat pixel: best = 0, c1 = c0
    agg[1, 1, -1] = 0                  # a best at D - 1
    for sub in (True, False):
        jd, jv = jsgm.winner_takes_all(jnp.asarray(agg), 0.96, sub)
        d, v = sgm.winner_takes_all(torch.tensor(agg), 0.96, sub)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("num_paths", [4, 8])
def test_aggregate_paths_calls_each_kernel_once(rng, monkeypatch,
                                                num_paths):
    """The repair: aggregate_paths goes through the wrappers of 2d, 2e and
    2g (so a CUDA tensor launches them), each exactly once."""
    calls = []

    def spy(name):
        real = getattr(sgm_kernel, name)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return wrapper

    for name in ("sgm_horizontal", "sgm_partial", "sgm_total"):
        monkeypatch.setattr(sgm_kernel, name, spy(name))
    cost = torch.tensor(rng.integers(0, 65, size=(6, 9, 8)).astype(np.uint8))
    agg = sgm.aggregate_paths(cost, num_paths=num_paths)
    assert calls == ["sgm_horizontal", "sgm_partial", "sgm_total"]
    np.testing.assert_array_equal(
        agg.numpy(), np.asarray(jsgm.aggregate_paths(
            jnp.asarray(cost.numpy().astype(np.int16)),
            num_paths=num_paths)))


@pytest.mark.parametrize("H,W,D,disp_bg,disp_fg,num_paths", [
    (64, 96, 32, 6.0, 16.0, 8), (45, 71, 24, 5.0, 11.0, 4)])
def test_stereo_sgm_volume_matches_jax(H, W, D, disp_bg, disp_fg,
                                       num_paths):
    """Path A against the JAX stereo_sgm on the CPU (its volume branch):
    disparity within 1e-5, valid masks equal."""
    L, R, _ = synth.stereo_pair(np.random.default_rng(H), H=H, W=W,
                                disp_bg=disp_bg, disp_fg=disp_fg)
    jd, jv = jsgm.stereo_sgm(jnp.asarray(L), jnp.asarray(R), max_disp=D,
                             num_paths=num_paths)
    sgm_kernel.reset_launches()
    d, v = sgm.stereo_sgm_volume(torch.tensor(L), torch.tensor(R),
                                 max_disp=D, num_paths=num_paths)
    assert all(k.launches == 0 for k in sgm_kernel.KERNELS)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    assert v.numpy().mean() > 0.5


def test_volume_wrappers_check_arguments():
    c = torch.zeros((4, 5, 8), dtype=torch.uint8)
    part = torch.zeros((4, 5, 8), dtype=torch.int16)
    with pytest.raises(TypeError):
        sgm_kernel.sgm_total(c, part.to(torch.int32))
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total(c, part[:, :4].contiguous())
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total(c, part, num_paths=2)
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total(c.to("meta"), part.to("meta"))
    with pytest.raises(ValueError):
        sgm_kernel.sgm_total(c, part, 10, 4032)     # 8 x (64 + P2) > int16
    with pytest.raises(TypeError):
        sgm_kernel.wta(part.to(torch.int64), 30000)
    with pytest.raises(ValueError):
        sgm_kernel.wta(part, 0.5)
    with pytest.raises(ValueError):
        sgm_kernel.wta(part.float(), 0.1)      # not exact in float32
    with pytest.raises(ValueError):
        sgm_kernel.wta(part.transpose(0, 1), 30000)
    with pytest.raises(ValueError):
        sgm_kernel.wta(part[:, :, :3].contiguous(), 30000)
