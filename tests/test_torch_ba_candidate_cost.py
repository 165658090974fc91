"""BA's LM candidate and its cost (`ops.ba_candidate_cost`), which every
`ba/lm.solve_lm` evaluates once an LM iteration and once to open a solve.

On the CPU `candidate_cost` is its plain version: the composition
`solve_lm` evaluated before the kernel (`backsub_points`, the candidate's
adds, `robust_cost(compute_residuals(.))`), written out below, bit for
bit, so every CPU solve keeps its bits.  The prior terms are added after
it, and only when the solve has priors: with every weight zero they are
exactly +0, so skipping them changes no bit.  On a CUDA tensor it is one
launch of `ops/csrc/ba_candidate_cost.cu` and never the plain version;
the kernel itself runs only on the card (the tests marked `card`, and
`chip_smoke.py` phase 3's `candidate_cost_phase`).
"""
import os
import re

import pytest
import torch

import chip_smoke
from metricsfm_tpu_torch.ba import lm
from metricsfm_tpu_torch.ba.lm import LMConfig
from metricsfm_tpu_torch.ops import ba_candidate_cost as cc
from metricsfm_tpu_torch.ops import projection
from metricsfm_tpu_torch.utils import synth
# by the test directory's own name: on the card's machine an installed
# package named `tests` hides this directory's
from torch_threads import torch_threads  # noqa: F401,E402


def _problem(views, dtype=torch.float64, shared=False, n_pts=60, seed=0,
             dev="cpu"):
    """The linearize kernel's test problem with tracks of `views` slots,
    60 % kept, a fifth of the points and a quarter of the cameras frozen,
    and the model of the first camera frozen."""
    n_cams = max(8, views + 2)
    prob = chip_smoke.linearize_problem(dev, n_pts, dtype, n_cams=n_cams,
                                        views=views, keep=0.6, seed=seed,
                                        shared=shared)
    g = torch.Generator().manual_seed(seed + 1)
    fdt = prob.points.dtype
    point_mut = (torch.rand(n_pts, generator=g) >= 0.2).to(fdt)
    pose_mut = (torch.rand(n_cams, generator=g) >= 0.25).to(fdt)
    intr_mut = torch.ones(prob.n_models, dtype=fdt)
    intr_mut[0] = 0.0
    return prob._replace(point_mut=point_mut.to(dev),
                         pose_mut=pose_mut.to(dev), intr_mut=intr_mut.to(dev))


def _step(prob, lam=1e-3, cfg=LMConfig()):
    """A real LM step of `prob` and the reduce's tensors it reads."""
    d_cam, aux = lm._camera_step(prob, lam, cfg, priors=False)
    return lm._step(prob, d_cam, aux)


def _args(prob):
    return (prob.poses, prob.intrs, prob.points, prob.cam_model,
            prob.track_cam, prob.track_uv, prob.track_weight,
            prob.track_mask)


def _composition(prob, step, delta):
    """solve_lm's candidate and its reprojection cost before the kernel,
    written out again: backsub_points, the adds, robust_cost of
    compute_residuals."""
    C, M = prob.n_cameras, prob.n_models
    d_cam = step.d_cam
    d9 = torch.cat([d_cam[:6 * C].reshape(C, 6),
                    d_cam[6 * C:].reshape(M, 3)[prob.cam_model]], dim=1)
    dc = d9[prob.track_cam]
    Et = torch.einsum("pvik,pvi->pk", step.W, dc)
    d_pt = -torch.einsum("pij,pj->pi", step.Hpp_inv, step.g_pt + Et)
    d_pt = d_pt * prob.point_mut[:, None]
    d_pose = d_cam[:6 * C].reshape(C, 6) * prob.pose_mut[:, None]
    d_intr = d_cam[6 * C:].reshape(M, 3) * prob.intr_mut[:, None]
    cand = prob._replace(poses=prob.poses + d_pose,
                         intrs=prob.intrs + d_intr,
                         points=prob.points + d_pt)
    return cand, _old_reprojection_cost(cand, delta)


def _old_reprojection_cost(prob, delta):
    """robust_cost(compute_residuals(prob)) as ba/lm wrote them."""
    cam = prob.track_cam
    r = projection.reprojection_residual(
        prob.poses[cam], prob.intrs[prob.cam_model[cam]],
        prob.points[:, None, :].expand(-1, prob.max_views, -1),
        prob.track_uv)
    r = r * torch.sqrt(prob.track_weight)[:, None, None] \
        * prob.track_mask.to(r.dtype)[:, :, None]
    s = torch.sum(r * r, dim=-1)
    rho = torch.where(s <= delta * delta, s,
                      2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-20))
                      - delta * delta)
    return 0.5 * torch.sum(rho * prob.track_mask.to(r.dtype))


def _old_problem_cost(prob, delta):
    """problem_cost as ba/lm wrote it: the prior terms always added."""
    rg = lm.gps_residuals(prob)
    rp = lm.pose_prior_residuals(prob)
    rt = lm.gps_triple_residuals(prob)
    return (_old_reprojection_cost(prob, delta) + 0.5 * torch.sum(rg * rg)
            + 0.5 * torch.sum(rp * rp) + 0.5 * torch.sum(rt * rt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("views", [1, 3, 16, 40])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("delta", [1.0, 0.05])
def test_plain_is_the_composition(dtype, views, shared, delta):
    """CPU tensors: the candidate and its cost bit for bit the
    composition above, on masked slots, frozen points, frozen cameras and
    a frozen model; no launch."""
    prob = _problem(views, dtype, shared)
    step = _step(prob)
    before = cc.candidate_cost.launches
    poses, intrs, points, cost = cc.candidate_cost(*_args(prob), delta,
                                                   step)
    assert cc.candidate_cost.launches == before
    cand, want = _composition(prob, step, delta)
    assert bool((~prob.track_mask).any())
    for got, w in ((poses, cand.poses), (intrs, cand.intrs),
                   (points, cand.points), (cost, want)):
        assert got.dtype == dtype
        assert torch.equal(got, w)
    assert cost.dim() == 0
    # the frozen dofs did not move
    frozen = prob.point_mut == 0
    assert bool(frozen.any()) and torch.equal(points[frozen],
                                              prob.points[frozen])
    fc = prob.pose_mut == 0
    assert bool(fc.any()) and torch.equal(poses[fc], prob.poses[fc])
    assert torch.equal(intrs[0], prob.intrs[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("views", [3, 16])
def test_cost_alone_is_the_old_cost(dtype, views):
    """Without a step: the problem's own tensors back, and its cost bit
    for bit robust_cost(compute_residuals(.))."""
    prob = _problem(views, dtype)
    poses, intrs, points, cost = cc.candidate_cost(*_args(prob), 1.0)
    assert poses is prob.poses and intrs is prob.intrs
    assert points is prob.points
    assert torch.equal(cost, _old_reprojection_cost(prob, 1.0))
    assert torch.equal(lm.robust_cost(lm.compute_residuals(prob),
                                      prob.track_mask, 1.0), cost)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_step", [False, True])
def test_zero_weight_priors_change_no_bit(dtype, with_step):
    """With every prior weight zero the cost without the prior terms
    equals the old problem_cost (which added them) exactly."""
    prob = _problem(16, dtype)
    assert not lm.has_priors(prob)
    step = _step(prob) if with_step else None
    cand, cost = lm._cost(prob, 1.0, priors=False, step=step)
    want = _old_problem_cost(cand, 1.0)
    assert torch.equal(cost, want)
    assert torch.equal(lm._cost(prob, 1.0, priors=True, step=step)[1], want)
    assert torch.equal(lm.problem_cost(cand, 1.0), want)


def _with_priors(prob):
    C = prob.n_cameras
    g = torch.Generator().manual_seed(7)
    dt = prob.points.dtype
    centers = projection.camera_center(prob.poses)
    trip = torch.stack([torch.arange(C - 2), torch.arange(1, C - 1),
                        torch.arange(2, C)], 1)
    return prob._replace(
        gps_pos=centers + 0.1 * torch.randn(C, 3, generator=g).to(dt),
        gps_weight=torch.full((C, 3), 0.5, dtype=dt),
        pose_prior=prob.poses + 0.01 * torch.randn(C, 6, generator=g).to(dt),
        pose_prior_weight=torch.full((C, 6), 0.2, dtype=dt),
        gps_triple=trip,
        gps_triple_weight=torch.full((C - 2, 2), 0.3, dtype=dt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_priors_are_still_added(dtype):
    """With nonzero prior weights the cost of a candidate is its
    reprojection cost plus the prior costs, as problem_cost adds them."""
    prob = _with_priors(_problem(16, dtype))
    assert lm.has_priors(prob)
    step = _step(prob)
    cand, cost = lm._cost(prob, 1.0, priors=True, step=step)
    assert torch.equal(cost, _old_problem_cost(cand, 1.0))
    reproj = lm._cost(prob, 1.0, priors=False, step=step)[1]
    assert float(cost) > float(reproj) > 0.0


@pytest.mark.parametrize("cg", [0, 30])
@pytest.mark.parametrize("priors", [False, True])
def test_solve_lm_takes_every_cost_from_the_op(monkeypatch, cg, priors):
    """solve_lm calls candidate_cost once to open the solve (no step) and
    once an LM iteration (the step of that iteration), dense and PCG; the
    numbers it reports are those costs, the priors added when it has
    them."""
    prob = _problem(6, torch.float64, n_pts=80)
    if priors:
        prob = _with_priors(prob)
    calls = []
    real = cc.candidate_cost

    def spy(*args):
        out = real(*args)
        calls.append((args[-1], out[3]))
        return out

    monkeypatch.setattr(cc, "candidate_cost", spy)
    cfg = LMConfig(max_iterations=4, cg_iterations=cg)
    _, info = lm.solve_lm(prob, cfg)
    assert len(calls) == info["iterations"] + 1
    assert calls[0][0] is None
    assert all(isinstance(s, cc.Step) for s, _ in calls[1:])
    first = calls[0][1]
    if priors:
        assert info["initial_cost"] > float(first)
    else:
        assert info["initial_cost"] == float(first)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what `candidate_cost`
    reads to pick its branch."""
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_card_tensors_never_reach_the_plain_version(monkeypatch):
    """A problem on the card goes to the kernel's launch with delta and
    the step, and never to the plain composition."""
    def no_plain(*args):
        raise AssertionError("the plain version reached with card tensors")

    calls = []

    def launch(*args):
        calls.append(args)
        return "kernel's result"

    monkeypatch.setattr(cc, "candidate_cost_plain", no_plain)
    monkeypatch.setattr(cc, "_launch", launch)
    prob = _problem(4, torch.float32, n_pts=20)
    step = cc.Step(*(t.as_subclass(_OnCard) for t in _step(prob)))
    args = [t.as_subclass(_OnCard) for t in _args(prob)]
    assert cc.candidate_cost(*args, 2.5, step) == "kernel's result"
    assert cc.candidate_cost(*args, 2.5) == "kernel's result"
    (a, b) = calls
    assert all(x is y for x, y in zip(a, args))
    assert a[-2:] == (2.5, step) and b[-2:] == (2.5, None)


def test_other_devices_raise(monkeypatch):
    def no_plain(*args):
        raise AssertionError("the plain version reached")

    monkeypatch.setattr(cc, "candidate_cost_plain", no_plain)
    args = [t.to("meta") for t in _args(_problem(4, n_pts=20))]
    with pytest.raises(ValueError, match="meta"):
        cc.candidate_cost(*args, 1.0)


@pytest.mark.parametrize("case,error", [
    ("half", TypeError), ("mixed", TypeError), ("int track_cam", TypeError),
    ("float mask", TypeError), ("int mut", TypeError),
    ("tensor delta", TypeError), ("points shape", ValueError),
    ("uv views", ValueError), ("d_cam length", ValueError),
    ("W shape", ValueError), ("Hpp_inv shape", ValueError),
    ("two devices", ValueError)])
def test_wrapper_checks_arguments(case, error):
    """Wrong types, shapes and devices raise before any work."""
    prob = _problem(4, torch.float32, n_pts=20)
    a, step, delta = list(_args(prob)), _step(prob), 1.0
    if case == "half":
        a = [t.half() if t.is_floating_point() else t for t in a]
    elif case == "mixed":
        step = step._replace(W=step.W.double())
    elif case == "int track_cam":
        a[4] = a[4].int()
    elif case == "float mask":
        a[7] = a[7].float()
    elif case == "int mut":
        step = step._replace(point_mut=step.point_mut.long())
    elif case == "tensor delta":
        delta = torch.tensor(1.0)
    elif case == "points shape":
        a[2] = a[2][:-1]
    elif case == "uv views":
        a[5] = a[5][:, :-1]
    elif case == "d_cam length":
        step = step._replace(d_cam=step.d_cam[:-1])
    elif case == "W shape":
        step = step._replace(W=step.W[..., :2])
    elif case == "Hpp_inv shape":
        step = step._replace(Hpp_inv=step.Hpp_inv[:-1])
    elif case == "two devices":
        step = step._replace(g_pt=step.g_pt.to("meta"))
    with pytest.raises(error):
        cc.candidate_cost(*a, delta, step)


def test_kernel_adds_no_float_atomics():
    """The kernel joins its blocks through an integer ticket: its source
    has no atomicAdd on a float or double (nor any other float atomic)."""
    src = os.path.join(os.path.dirname(cc.__file__), "csrc",
                       "ba_candidate_cost.cu")
    with open(src) as f:
        text = f.read()
    code = re.sub(r"//[^\n]*", "", text)
    atomics = re.findall(r"\batomic\w*\s*\(([^,]*),", code)
    assert atomics == ["ticket"], atomics
    assert "int* __restrict__ ticket" in code


# -- the kernel itself: on the card only --------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the candidate kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _to64(x):
    if isinstance(x, cc.Step):
        return cc.Step(*(t.double() for t in x))
    return x.double() if x.is_floating_point() else x


def _card_case(n_pts, dtype, seed):
    """The BA cell's widths on the card (64 cameras, V 16, 41 % kept, a
    tenth of the points frozen), a real step, its f64 copy."""
    dev = _card()
    prob = chip_smoke.linearize_problem(dev, n_pts, dtype, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    prob = prob._replace(point_mut=(torch.rand(
        n_pts, generator=g, device=dev) >= 0.1).to(dtype))
    step = _step(prob)
    p64 = prob._replace(**{k: _to64(getattr(prob, k)) for k in
                           prob._fields})
    return prob, step, p64, _to64(step)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_pts", chip_smoke.LINEARIZE_SHAPES)
def test_kernel_on_the_card(dtype, n_pts):
    """The kernel against the plain version on the same step at the BA
    cell's widths: float32 candidate points within twice the plain
    version's error against the float64 truth plus 1e-6 (relative to the
    largest entry), the cost likewise; float64 within 1e-12 of the plain
    version.  Poses and models bit for bit the plain version's (two
    roundings, no contraction); bit-equal over two launches.  On a
    problem whose every slot's term is exact in float32
    (`chip_smoke.exact_cost_problem`), the cost alone no farther from the
    exact cost than the plain float32 sum of the same terms."""
    prob, step, p64, s64 = _card_case(n_pts, dtype, seed=n_pts)
    before = cc.candidate_cost.launches
    got = [cc.candidate_cost(*_args(prob), 1.0, step) for _ in range(2)]
    assert cc.candidate_cost.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*got))
    got = got[0]
    plain = cc.candidate_cost_plain(*_args(prob), 1.0, step)
    truth = cc.candidate_cost_plain(*_args(p64), 1.0, s64)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert got[3].dim() == 0 and got[3].dtype == dtype
    scale = float(truth[2].abs().max())
    ek = float((got[2].double() - truth[2]).abs().max()) / scale
    ep = float((plain[2].double() - truth[2]).abs().max()) / scale
    ck = abs(float(got[3]) - float(truth[3])) / float(truth[3])
    cp = abs(float(plain[3]) - float(truth[3])) / float(truth[3])
    if dtype == torch.float64:
        assert ek <= 1e-12 and ck <= 1e-12, (ek, ck)
        return
    assert ek <= 2 * ep + 1e-6, (ek, ep)
    assert ck <= 2 * cp + 1e-6, (ck, cp)
    ex = chip_smoke.exact_cost_problem(prob.points.device, n_pts, dtype)
    exact = float(cc.candidate_cost_plain(
        *_args(ex._replace(**{k: _to64(getattr(ex, k))
                              for k in ex._fields})), 10.0)[3])
    kernel = float(cc.candidate_cost(*_args(ex), 10.0)[3])
    f32_sum = float(cc.candidate_cost_plain(*_args(ex), 10.0)[3])
    assert abs(kernel - exact) <= abs(f32_sum - exact), (kernel, f32_sum,
                                                         exact)


def _plain(*args):
    """candidate_cost with the plain version on any device."""
    return cc.candidate_cost_plain(*args)


def _noisy(seed, dev):
    prob = synth.synthetic_ba_problem(64, 32768, 16, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return prob._replace(track_uv=prob.track_uv + 0.5 * torch.randn(
        prob.track_uv.shape, generator=g, device=dev))


@pytest.mark.card
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_solve_lm_on_the_card(solver, monkeypatch):
    """solve_lm at the cell's widths (64 cameras, V 16, 32,768 points)
    with the kernel: one launch an LM iteration and one a solve; two
    solves bit-equal; the plain version forced gives the final cost
    within 1e-5 relative and the iteration count within one."""
    dev = _card()
    prob = _noisy(21 if solver == "dense" else 22, dev)
    cfg = LMConfig(max_iterations=15, rtol=1e-4)
    if solver == "pcg":
        cfg = cfg._replace(cg_iterations=100, cg_tol=1e-6, cg_forcing=False)
    before = cc.candidate_cost.launches
    ok, ik = lm.solve_lm(prob, cfg)
    assert cc.candidate_cost.launches - before == ik["iterations"] + 1
    again, ia = lm.solve_lm(prob, cfg)
    assert ia == ik
    for k in ("poses", "intrs", "points"):
        assert torch.equal(getattr(ok, k), getattr(again, k)), k
    monkeypatch.setattr(cc, "candidate_cost", _plain)
    _, ip = lm.solve_lm(prob, cfg)
    assert ik["final_cost"] < ik["initial_cost"]
    assert abs(ik["final_cost"] - ip["final_cost"]) \
        <= 1e-5 * ip["final_cost"], (ik, ip)
    assert abs(ik["iterations"] - ip["iterations"]) <= 1
