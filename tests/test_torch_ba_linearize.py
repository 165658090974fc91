"""BA's linearization of the observation slots (`ops.ba_linearize`,
called by `ba/lm._linearize`).

On the CPU `linearize` is its plain version, `linearize_plain`:
`vmap(jacfwd)` of the reprojection residual scaled by the track weights,
the mask and the Huber weights, bit for bit the composition the port used
before the kernel on every kept slot, so the JAX parity tests of
`tests/test_torch_ba.py` keep their numbers.  A masked slot is zero, also
where its projection's derivative is not finite (the composition leaves
NaN * 0 there).  On a CUDA tensor it is one launch of
`ops/csrc/ba_linearize.cu` (analytic Jacobians) and never the plain
version; the kernel itself runs only on the card (`test_kernel_on_the_card`,
`test_solve_lm_on_the_card`, and `chip_smoke.py` phase 3's
`linearize_phase`).
"""
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import chip_smoke
from metricsfm_tpu_torch.ba import lm
from metricsfm_tpu_torch.ba.lm import LMConfig
from metricsfm_tpu_torch.ops import ba_linearize, projection
from metricsfm_tpu_torch.utils import synth
# by the test directory's own name: on the card's machine an installed
# package named `tests` hides this directory's
from torch_threads import torch_threads  # noqa: F401,E402


def _problem(dtype=torch.float32, shared=False, n_pts=200):
    """A small CPU problem from the kernel phase's builder: 8 cameras,
    tracks of 6 slots, 60 % kept."""
    return chip_smoke.linearize_problem("cpu", n_pts, dtype, n_cams=8,
                                        views=6, keep=0.6, seed=0,
                                        shared=shared)


def _composition(prob, delta):
    """The port's linearization before the kernel, written out again."""
    def aux(*args):
        r = projection.reprojection_residual(*args)
        return r, r
    rj = vmap(jacfwd(aux, argnums=(0, 1, 2), has_aux=True))
    P, V = prob.track_cam.shape
    cam = prob.track_cam
    poses = prob.poses[cam]
    intrs = prob.intrs[prob.cam_model[cam]]
    pts = prob.points[:, None, :].expand(-1, V, -1)
    (Jpo, Jin, Jpt), r = rj(poses.reshape(-1, 6), intrs.reshape(-1, 3),
                            pts.reshape(-1, 3), prob.track_uv.reshape(-1, 2))
    w = torch.sqrt(prob.track_weight)[:, None, None]
    m = prob.track_mask.to(r.dtype)[:, :, None]
    scale = (w * m)[..., None]
    r, Jpo, Jin, Jpt = (r.reshape(P, V, 2) * w * m,
                        Jpo.reshape(P, V, 2, 6) * scale,
                        Jin.reshape(P, V, 2, 3) * scale,
                        Jpt.reshape(P, V, 2, 3) * scale)
    s = torch.sum(r * r, dim=-1)
    w2 = torch.where(s <= delta * delta, 1.0,
                     delta / torch.sqrt(torch.clamp(s, min=1e-20)))
    rw = torch.sqrt(w2)[..., None]
    return (r * rw, Jpo * rw[..., None], Jin * rw[..., None],
            Jpt * rw[..., None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("delta", [1.0, 1e6])
def test_cpu_linearize_is_the_plain_composition(dtype, shared, delta):
    """CPU tensors: the plain version, bit for bit the composition above,
    Huber on (delta 1 px: most slots above it) and off; no launch."""
    prob = _problem(dtype=dtype, shared=shared)
    before = ba_linearize.linearize.launches
    got = lm._linearize(prob, LMConfig(huber_delta=delta))
    want = _composition(prob, delta)
    assert ba_linearize.linearize.launches == before
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    r = got[0]
    s = torch.sum(r * r, dim=-1)
    assert bool((s > delta * delta).any()) == (delta == 1.0)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what `linearize` reads to
    pick its branch."""
    @property
    def device(self):
        return torch.device("cuda", 0)


FIELDS = ("poses", "intrs", "points", "cam_model", "track_cam", "track_uv",
          "track_weight", "track_mask")


def _no_plain(monkeypatch):
    """Make every entry into the plain version fail the test."""
    def no_plain(*args):
        raise AssertionError("vmap(jacfwd) reached")

    monkeypatch.setattr(ba_linearize, "_rj", no_plain)
    monkeypatch.setattr(ba_linearize, "linearize_plain", no_plain)


def test_card_tensors_never_reach_the_plain_version(monkeypatch):
    """A problem on the card goes to the kernel's launch, with the
    problem's fields and the Huber threshold, and never to vmap(jacfwd)."""
    calls = []

    def launch(*args):
        calls.append(args)
        return "kernel's result"

    _no_plain(monkeypatch)
    monkeypatch.setattr(ba_linearize, "_launch", launch)
    prob = _problem()
    prob = prob._replace(**{f: getattr(prob, f).as_subclass(_OnCard)
                            for f in FIELDS})
    assert lm._linearize(prob, LMConfig(huber_delta=2.5)) == "kernel's result"
    (args,) = calls
    assert all(a is getattr(prob, f) for a, f in zip(args, FIELDS))
    assert args[-1] == 2.5


def test_other_devices_raise(monkeypatch):
    _no_plain(monkeypatch)
    prob = _problem()
    prob = prob._replace(**{f: getattr(prob, f).to("meta")
                            for f in prob._fields})
    with pytest.raises(ValueError, match="meta"):
        lm._linearize(prob, LMConfig())


def _padded_problem(seed=0):
    """A padded float32 problem, as `to_ba_problem` pads: every slot of
    camera 0 masked (a padding camera, frozen; camera 1 frozen for the
    gauge), masked slots at camera 0 with uv 0, radial distortion, 0.5 px
    of noise.  Camera 0 is placed so that track 0's point lies 1e-5 in
    front of its image plane, 30 units off its axis: that padded slot's
    residual is finite (~1e32 px) but its derivative overflows float32,
    so vmap(jacfwd) gives it NaN Jacobians."""
    prob = synth.synthetic_ba_problem(8, 64, 4, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    pad = prob.track_cam == 0
    pad[0, -1] = True
    at = torch.tensor([30.0, 15.0, 1e-5], dtype=torch.float64)
    poses = prob.poses.clone()
    poses[0] = torch.cat([torch.zeros(3, dtype=torch.float64),
                          at - prob.points[0].double()])
    intrs = prob.intrs.clone()
    intrs[:, 1:] = torch.tensor([-0.03, 0.01])
    noise = 0.5 * torch.randn(prob.track_uv.shape, generator=g)
    return prob._replace(
        poses=poses, intrs=intrs, track_mask=~pad,
        track_cam=torch.where(pad, 0, prob.track_cam),
        track_uv=torch.where(pad[..., None], 0.0, prob.track_uv + noise),
        pose_mut=prob.pose_mut.index_fill(0, torch.tensor([1]), 0.0))


def test_masked_slots_that_do_not_project_are_zero():
    """A padded slot whose projection has no finite derivative: the
    composition leaves it NaN (NaN * 0), the plain version zero, as the
    kernel writes it; every kept slot bit for bit the composition.  One
    PCG solve then lowers the cost, where the NaN would have poisoned
    every step."""
    prob = _padded_problem()
    old = _composition(prob, 1.0)
    assert any(bool(o[0, -1].isnan().any()) for o in old)
    got = lm._linearize(prob, LMConfig(huber_delta=1.0))
    kept = prob.track_mask
    for g, o in zip(got, old):
        assert bool((g[~kept] == 0).all())
        torch.testing.assert_close(g[kept], o[kept], rtol=0, atol=0)
    _, info = lm.solve_lm(prob, LMConfig(max_iterations=10,
                                         cg_iterations=50))
    assert np.isfinite(info["final_cost"])
    assert info["final_cost"] < info["initial_cost"]


def _args(prob):
    return [getattr(prob, f) for f in FIELDS]


@pytest.mark.parametrize("case,error", [
    ("half", TypeError), ("mixed", TypeError), ("int32 cameras", TypeError),
    ("float mask", TypeError), ("uv shape", ValueError),
    ("weight shape", ValueError), ("pose width", ValueError),
    ("cpu", ValueError)])
def test_wrapper_checks_arguments(case, error):
    """Wrong types, shapes and devices raise before any launch ("cpu":
    the mask left on the CPU beside the rest on another device)."""
    prob = _problem(n_pts=20)
    a = _args(prob)
    if case == "half":
        a = [t.half() if t.is_floating_point() else t for t in a]
    elif case == "mixed":
        a[0] = a[0].double()
    elif case == "int32 cameras":
        a[4] = a[4].int()
    elif case == "float mask":
        a[7] = a[7].float()
    elif case == "uv shape":
        a[5] = a[5][:, :-1]
    elif case == "weight shape":
        a[6] = a[6][:-1]
    elif case == "pose width":
        a[0] = a[0][:, :5]
    elif case == "cpu":
        a = [t.to("meta") for t in a[:7]] + a[7:]
    before = ba_linearize.linearize.launches
    with pytest.raises(error):
        ba_linearize.linearize(*a, 1.0)
    assert ba_linearize.linearize.launches == before


# -- the kernel itself: on the card only --------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the linearize kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _blocks_close(got, plain, truth, dtype, where):
    """Per block (r, Jpose, Jintr, Jpt), errors relative to the block's
    largest entry of the float64 plain version (`truth`).  float64: the
    kernel within 1e-12 of it (both evaluate the same expressions; the
    order of operations differs).  float32, without the Huber weight: the
    kernel no less accurate than the float32 plain version against the
    same truth, within twice its error and 1e-6 (the two round at other
    places: FMA contraction, the analytic chain).  Returns the relative
    errors."""
    errs = []
    for name, k, p, t in zip(("r", "Jpose", "Jintr", "Jpt"), got, plain,
                             truth):
        k, p, t = (x[where].double() for x in (k, p, t))
        scale = float(t.abs().max())
        ek = float((k - t).abs().max()) / scale
        ep = float((p - t).abs().max()) / scale
        errs.append((name, ek, ep))
        if dtype == torch.float64:
            assert ek <= 1e-12, (name, ek)
        else:
            assert ek <= 2 * ep + 1e-6, (name, ek, ep)
    return errs


def _weights_close(got, raw, delta, where):
    """float32 with the Huber weight: the kernel's weighted blocks within
    1e-6 of a block's largest entry of its own unweighted blocks `raw`
    scaled by the weight of their residual (chip_smoke.huber_rescaled).
    Not against the float64 truth: r = projection - observation loses
    ~1e-4 of itself to rounding at |r| ~ 1 px of ~2e3, in both versions,
    and the weight carries that into every block, so the largest error
    over many slots is rounding noise (1.4e-5 to 1.05e-4 for the float32
    plain version at the cell's widths, 3e-7 to 3e-6 without the
    weight)."""
    errs = chip_smoke.huber_errors(got, raw, delta, where)
    assert max(errs) <= 1e-6, errs
    return errs


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [True, False])
def test_kernel_on_the_card(dtype, shared):
    """The kernel against the plain version at the benchmark cell's widths
    (V = 16 views a track, P = 32,768 points, 64 cameras; ~40 % of the
    slots kept, as the survey's tracks keep 6.6 of 16), with Huber on and
    off, one shared camera model (UAV) and one a camera (web); contiguous
    outputs; bit-equal over repeats; masked slots zero.  Needs
    an NVIDIA GPU: `python -m pytest tests/test_torch_ba_linearize.py -q
    -m card` on the card."""
    dev = _card()
    prob = chip_smoke.linearize_problem(dev, 32768, dtype, seed=3,
                                        shared=shared)
    p64 = prob._replace(**{k: getattr(prob, k).double() for k in
                           ("poses", "intrs", "points", "track_uv",
                            "track_weight")})
    kept = prob.track_mask
    for delta in (float("inf"), 1.0):
        cfg = LMConfig(huber_delta=delta)
        before = ba_linearize.linearize.launches
        got = [lm._linearize(prob, cfg) for _ in range(2)]
        assert ba_linearize.linearize.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(*got))
        got = got[0]
        assert all(g.is_contiguous() for g in got)
        if delta > 1.0 or dtype == torch.float64:
            plain = chip_smoke.linearize_plain(prob, cfg)
            truth = chip_smoke.linearize_plain(p64, cfg)
            _blocks_close(got, plain, truth, dtype, kept)
        else:
            _weights_close(got, raw, delta, kept)
        raw = got
        assert all(bool((g[~kept] == 0).all()) for g in got)
        s = torch.sum(got[0] * got[0], dim=-1)[kept]
        assert bool((s > delta * delta).any()) == (delta == 1.0)


def _edge_problem(dev, dtype):
    """Slots at the kernel's branches: cameras with theta^2 at 0, 0.5e-8,
    0.99e-8 and 1.01e-8 (both sides of the small-angle switch at 1e-8);
    points at camera-frame z = 1e-13, -3e-13 (clamped to 1e-12) and
    2e-12 (not), each in its track's first camera; and the masked slots
    of a track whose point is at infinity (a padding point's), which
    vmap(jacfwd) projects to NaN and both versions write as 0."""
    prob = chip_smoke.linearize_problem("cpu", 64, torch.float64, n_cams=8,
                                        views=6, keep=1.0, seed=5,
                                        shared=False)
    g = torch.Generator().manual_seed(7)
    poses = prob.poses.clone()
    for c, th2 in enumerate((0.0, 0.5e-8, 0.99e-8, 1.01e-8)):
        axis = torch.randn(3, generator=g, dtype=torch.float64)
        poses[c, :3] = axis / axis.norm() * th2 ** 0.5
    pts, mask = prob.points.clone(), prob.track_mask.clone()
    for i, pc in enumerate(([0.3, -0.2, 1e-13], [0.1, 0.2, -3e-13],
                            [-0.2, 0.1, 2e-12])):
        cam = int(prob.track_cam[i, 0])
        R, t = projection.pose_to_Rt(poses[cam])
        pts[i] = R.T @ (torch.tensor(pc, dtype=torch.float64) - t)
    pts[3] = torch.tensor([float("inf"), 0.0, 0.0])
    mask[3] = False
    prob = prob._replace(poses=poses, points=pts, track_mask=mask)
    floats = ("poses", "intrs", "points", "track_uv", "track_weight")
    return prob._replace(**{k: getattr(prob, k).to(dev, dtype)
                            for k in floats},
                         **{k: getattr(prob, k).to(dev)
                            for k in prob._fields if k not in floats})


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_edges_on_the_card(dtype):
    """The branches of `_edge_problem`.  float64: every kept slot within
    1e-12 of its own largest entry of the plain version (the clamped
    slots' entries are ~1e12 times the others', so each slot is its own
    scale).  float32: the slots off the clamp as in `_blocks_close`
    without the Huber weight and `_weights_close` with it (the clamped
    ones divide by 1e-12 and overflow float32's distortion polynomial in
    both versions).  The masked slots: zeros in both versions, where the
    composition has NaN."""
    dev = _card()
    prob = _edge_problem(dev, dtype)
    cfg = LMConfig(huber_delta=1.0)
    got = lm._linearize(prob, cfg)
    plain = chip_smoke.linearize_plain(prob, cfg)
    kept = prob.track_mask
    assert all(bool((g[3] == 0).all()) for g in got)
    assert all(bool((p[3] == 0).all()) for p in plain)
    assert any(bool(o[3].isnan().any()) for o in _composition(prob, 1.0))
    if dtype == torch.float64:
        for k, p in zip(got, plain):
            k, p = k[kept].reshape(int(kept.sum()), -1), \
                p[kept].reshape(int(kept.sum()), -1)
            err = (k - p).abs().amax(1) / p.abs().amax(1)
            assert float(err.max()) <= 1e-12
    else:
        off = kept.clone()
        off[:3, 0] = False
        unweighted = LMConfig(huber_delta=float("inf"))
        raw = lm._linearize(prob, unweighted)
        truth = chip_smoke.linearize_plain(
            _edge_problem(dev, torch.float64), unweighted)
        _blocks_close(raw, chip_smoke.linearize_plain(prob, unweighted),
                      truth, dtype, off)
        _weights_close(got, raw, 1.0, off)


@pytest.mark.card
def test_solve_lm_on_the_card(monkeypatch):
    """solve_lm at the cell's widths (dense Schur, 64 cameras, V = 16)
    with the kernel and with the plain version forced: the same final cost
    within 1e-5 relative, iteration counts within one."""
    dev = _card()
    prob = synth.synthetic_ba_problem(64, 32768, 16, seed=11, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    prob = prob._replace(track_uv=prob.track_uv + 0.5 * torch.randn(
        prob.track_uv.shape, generator=g, device=dev))
    cfg = LMConfig(max_iterations=15, rtol=1e-4)
    before = ba_linearize.linearize.launches
    _, ik = lm.solve_lm(prob, cfg)
    assert ba_linearize.linearize.launches - before == ik["iterations"]
    monkeypatch.setattr(ba_linearize, "_launch", ba_linearize.linearize_plain)
    _, ip = lm.solve_lm(prob, cfg)
    assert ba_linearize.linearize.launches - before == ik["iterations"]
    assert ik["final_cost"] < ik["initial_cost"]
    assert abs(ik["final_cost"] - ip["final_cost"]) \
        <= 1e-5 * ip["final_cost"], (ik, ip)
    assert abs(ik["iterations"] - ip["iterations"]) <= 1
    np.testing.assert_allclose(ik["initial_cost"], ip["initial_cost"],
                               rtol=1e-6)
