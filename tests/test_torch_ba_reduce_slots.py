"""BA's reduce of the observation slots (`ops.ba_reduce_slots`), which
both camera solvers of `ba/lm` run.

On the CPU `reduce_slots` is its plain version: the einsums and closed-form
3x3 inverse and Cholesky `ba/lm.partial_camera_system` evaluated before
the kernel, grouped into per-slot camera and model rows.  Its point
blocks, W, U and JᵀJ blocks are bit for bit the composition written out
below, and so is S after the sums; the right-hand side is now the sum of
rv = W y - Jcᵀ r, where it was the difference of two sums, so it agrees to
the rounding of its terms.  The PCG path's `_track_terms` are bit for bit
the inline einsums it ran before it reduced through `reduce_slots`.  On a
CUDA tensor it is one launch of `ops/csrc/ba_reduce_slots.cu` and never
the plain version; the kernel itself runs only on the card (the tests
marked `card`, and `chip_smoke.py` phase 3's `reduce_slots_phase`).
"""
import pytest
import torch

import chip_smoke
from metricsfm_tpu_torch.ba import lm
from metricsfm_tpu_torch.ba.lm import LMConfig
from metricsfm_tpu_torch.ops import ba_reduce_slots
from metricsfm_tpu_torch.ops.segsum import segment_sum
from metricsfm_tpu_torch.utils import synth
# by the test directory's own name: on the card's machine an installed
# package named `tests` hides this directory's
from torch_threads import torch_threads  # noqa: F401,E402

NAMES = chip_smoke.REDUCE_NAMES


def _problem(views, dtype=torch.float64, shared=False, n_pts=60, seed=0,
             dev="cpu"):
    """The linearize kernel's test problem (`chip_smoke.linearize_problem`)
    with tracks of `views` slots, 60 % kept, one camera model for all
    (`shared`) or one a camera, and a fifth of the points frozen."""
    prob = chip_smoke.linearize_problem(dev, n_pts, dtype,
                                        n_cams=max(8, views + 2),
                                        views=views, keep=0.6, seed=seed,
                                        shared=shared)
    g = torch.Generator().manual_seed(seed + 1)
    frozen = torch.rand(n_pts, generator=g) < 0.2
    return prob._replace(point_mut=(~frozen).to(prob.point_mut.dtype).to(
        prob.point_mut.device))


def _slots(prob, delta=1.0):
    return lm._linearize(prob, LMConfig(huber_delta=delta))


def _composition(r, Jpo, Jin, Jpt, point_mut, lam):
    """partial_camera_system's per-slot and per-point terms before the
    kernel, written out again: (Hpp_inv, g_pt, W, U, the camera terms
    JpoᵀJpo, JpoᵀJin, Jpoᵀr and corr[:6], the model terms JinᵀJin, Jinᵀr
    and corr[6:]), corr = W Hpp_inv g_pt."""
    dtype = r.dtype
    g_pt = torch.einsum("pvri,pvr->pi", Jpt, r)
    Hpp = torch.einsum("pvri,pvrj->pij", Jpt, Jpt)
    diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(diag_pp, min=1e-12) + 1e-12
    Hpp_d = Hpp + torch.diag_embed(damp)
    pm = point_mut[:, None, None]
    Hpp_d = Hpp_d * pm + torch.eye(3, dtype=dtype) * (1.0 - pm)
    Hpp_inv = ba_reduce_slots.inv3x3(Hpp_d)
    Jc = torch.cat([Jpo, Jin], dim=-1)
    W = torch.einsum("pvri,pvrj->pvij", Jc, Jpt) \
        * point_mut[:, None, None, None]
    U = torch.einsum("pvij,pjk->pvik", W, ba_reduce_slots.chol3x3(Hpp_inv))
    y = torch.einsum("pij,pj->pi", Hpp_inv, g_pt)
    corr = torch.einsum("pvij,pj->pvi", W, y)
    cam = (torch.einsum("pvri,pvrj->pvij", Jpo, Jpo),
           torch.einsum("pvri,pvrj->pvij", Jpo, Jin),
           torch.einsum("pvri,pvr->pvi", Jpo, r), corr[..., :6])
    model = (torch.einsum("pvri,pvrj->pvij", Jin, Jin),
             torch.einsum("pvri,pvr->pvi", Jin, r), corr[..., 6:])
    return Hpp_inv, g_pt, W, U, cam, model


def _old_system(prob, lam, plans):
    """S and rhs as partial_camera_system assembled them before the
    kernel: per-term segment sums, index_put_ into zeros, rhs = -g_cam +
    the sums of corr."""
    C, M, P = prob.n_cameras, prob.n_models, prob.n_points
    D = 6 * C + 3 * M
    r, Jpo, Jin, Jpt = _slots(prob)
    Hpp_inv, g_pt, W, U, cam, model = _composition(
        r, Jpo, Jin, Jpt, prob.point_mut.to(r.dtype), lam)
    Hcc_pose, Hcc_pi, g_pose, corr_pose = cam
    Hcc_intr, g_intr, corr_intr = model
    S = torch.zeros((D, D), dtype=r.dtype)
    pose_rows = 6 * torch.arange(C)[:, None] + torch.arange(6)
    intr_rows = 6 * C + 3 * torch.arange(M)[:, None] + torch.arange(3)
    pi_cols = 6 * C + 3 * prob.cam_model[:, None] + torch.arange(3)
    Hpi = segment_sum(Hcc_pi, plans.cam)
    S[pose_rows[:, :, None], pose_rows[:, None, :]] = segment_sum(
        Hcc_pose, plans.cam)
    S[intr_rows[:, :, None], intr_rows[:, None, :]] = segment_sum(
        Hcc_intr, plans.model)
    S[pose_rows[:, :, None], pi_cols[:, None, :]] = Hpi
    S[pi_cols[:, :, None], pose_rows[:, None, :]] = Hpi.transpose(-1, -2)
    G_pose = segment_sum(U[:, :, :6], plans.point_cam).reshape(P, C, 6, 3)
    G_intr = segment_sum(U[:, :, 6:], plans.point_model).reshape(P, M, 3, 3)
    G = torch.cat([G_pose.permute(1, 2, 0, 3).reshape(6 * C, 3 * P),
                   G_intr.permute(1, 2, 0, 3).reshape(3 * M, 3 * P)])
    S = S - G @ G.T
    g_cam = torch.cat([segment_sum(g_pose, plans.cam).reshape(-1),
                       segment_sum(g_intr, plans.model).reshape(-1)])
    corr = torch.cat([segment_sum(corr_pose, plans.cam).reshape(-1),
                      segment_sum(corr_intr, plans.model).reshape(-1)])
    return S, -g_cam + corr, (g_cam, corr)


VIEWS = [1, 3, 16, 40]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("views", VIEWS)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_plain_is_the_composition(dtype, views, shared, lam):
    """CPU tensors: the plain version, bit for bit the composition above
    on every per-slot and per-point term, rv its corr - Jcᵀr; no launch.
    Masked slots write zeros; frozen points get the identity block and a
    zero W."""
    prob = _problem(views, dtype, shared)
    slots = _slots(prob)
    before = ba_reduce_slots.reduce_slots.launches
    got = dict(zip(NAMES, ba_reduce_slots.reduce_slots(
        *slots, prob.point_mut, lam)))
    assert ba_reduce_slots.reduce_slots.launches == before
    P, V = prob.track_cam.shape
    want = _composition(*slots, prob.point_mut.to(dtype), lam)
    for name, w in zip(NAMES[:4], want[:4]):
        assert got[name].dtype == dtype
        torch.testing.assert_close(got[name], w, rtol=0, atol=0)
    cam_t, model_t = want[4], want[5]
    exact = {"cam": (got["cam"][..., :54], torch.cat(
                 [cam_t[0].reshape(P, V, 36), cam_t[1].reshape(P, V, 18)],
                 -1)),
             "model": (got["model"][..., :9], model_t[0].reshape(P, V, 9))}
    for name, (g, w) in exact.items():
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    rv = torch.cat([got["cam"][..., 54:], got["model"][..., 9:]], -1)
    torch.testing.assert_close(
        rv, torch.cat([cam_t[3] - cam_t[2], model_t[2] - model_t[1]], -1),
        rtol=0, atol=0)
    masked = ~prob.track_mask
    assert bool(masked.any())
    for name in ("W", "U", "cam", "model"):
        assert bool((got[name][masked] == 0).all()), name
    frozen = prob.point_mut == 0
    assert bool(frozen.any())
    torch.testing.assert_close(got["Hpp_inv"][frozen],
                               torch.eye(3, dtype=dtype).expand(
                                   int(frozen.sum()), 3, 3),
                               rtol=0, atol=0)
    assert bool((got["W"][frozen] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("views", VIEWS)
@pytest.mark.parametrize("shared", [False, True])
def test_system_after_the_sums(dtype, views, shared):
    """partial_camera_system's S bit for bit the one the per-term sums and
    index_put_ gave, its rhs within the rounding of the terms it sums:
    Σ(corr - g) against Σcorr - Σg, each of |rhs| <= |Σg| + |Σcorr|, so
    within 64 units of roundoff of that scale."""
    prob = _problem(views, dtype, shared)
    plans = lm.make_plans(prob, LMConfig(), False)
    S, rhs, aux = lm.partial_camera_system(prob, 1e-3, LMConfig(), plans)
    S0, rhs0, (g_cam, corr) = _old_system(prob, 1e-3, plans)
    torch.testing.assert_close(S, S0, rtol=0, atol=0)
    scale = float((g_cam.abs() + corr.abs()).max())
    torch.testing.assert_close(rhs, rhs0, rtol=0,
                               atol=64 * torch.finfo(dtype).eps * scale)
    assert set(aux) == {"W", "Hpp_inv", "g_pt"}
    # back-substitution reads what the plain version wrote
    got = ba_reduce_slots.reduce_slots(*_slots(prob), prob.point_mut, 1e-3)
    for name, t in (("Hpp_inv", got[0]), ("g_pt", got[1]), ("W", got[2])):
        torch.testing.assert_close(aux[name], t, rtol=0, atol=0)


def test_partial_camera_system_reduces_through_the_wrapper(monkeypatch):
    """The dense path takes its per-slot terms from one call of
    reduce_slots, with the problem's point_mut and the damping."""
    prob = _problem(6, torch.float32)
    calls = []
    real = ba_reduce_slots.reduce_slots

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(ba_reduce_slots, "reduce_slots", spy)
    lm.partial_camera_system(prob, 0.25, LMConfig())
    (args,) = calls
    assert args[4] is prob.point_mut and args[5] == 0.25


def test_track_terms_reduce_through_the_wrapper(monkeypatch):
    """The PCG path takes its per-slot terms from one call of
    reduce_slots, with the problem's point_mut and the damping."""
    prob = _problem(6, torch.float32)
    calls = []
    real = ba_reduce_slots.reduce_slots

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(ba_reduce_slots, "reduce_slots", spy)
    lm._track_terms(prob, 0.25, LMConfig(cg_iterations=10))
    (args,) = calls
    assert args[4] is prob.point_mut and args[5] == 0.25


def _old_track_terms(prob, lam, cfg, plans):
    """_track_terms' Jc, W, Hpp_inv, block-Jacobi blocks and rhs as its
    inline einsums gave them before it reduced through reduce_slots."""
    dtype = prob.points.dtype
    r, Jpo, Jin, Jpt = lm._linearize(prob, cfg)
    pm = prob.point_mut
    eye3 = torch.eye(3, dtype=dtype)
    Hpp = torch.einsum("pvri,pvrj->pij", Jpt, Jpt)
    diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(diag_pp, min=1e-12) + 1e-12
    Hpp_d = Hpp + torch.diag_embed(damp)
    Hpp_d = Hpp_d * pm[:, None, None] + eye3 * (1.0 - pm)[:, None, None]
    Hpp_inv = ba_reduce_slots.inv3x3(Hpp_d)
    Jc = torch.cat([Jpo, Jin], dim=-1)
    W = torch.einsum("pvri,pvrj->pvij", Jc, Jpt) * pm[:, None, None, None]
    U = torch.einsum("pvij,pjk->pvik", W, ba_reduce_slots.chol3x3(Hpp_inv))
    g_pt = torch.einsum("pvri,pvr->pi", Jpt, r)
    y = torch.einsum("pij,pj->pi", Hpp_inv, g_pt)
    rv = torch.einsum("pvij,pj->pvi", W, y) \
        - torch.einsum("pvri,pvr->pvi", Jc, r)
    rhs = torch.cat([segment_sum(rv[..., :6], plans.cam).reshape(-1),
                     segment_sum(rv[..., 6:], plans.model).reshape(-1)])
    blk_pose = segment_sum(
        torch.einsum("pvri,pvrj->pvij", Jpo, Jpo)
        - torch.einsum("pvik,pvjk->pvij", U[:, :, :6], U[:, :, :6]),
        plans.cam)
    blk_intr = segment_sum(
        torch.einsum("pvri,pvrj->pvij", Jin, Jin)
        - torch.einsum("pvik,pvjk->pvij", U[:, :, 6:], U[:, :, 6:]),
        plans.model)
    return {"Jc": Jc, "W": W, "Hpp_inv": Hpp_inv, "blk_pose": blk_pose,
            "blk_intr": blk_intr, "rhs": rhs, "g_pt": g_pt}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("views", [3, 16])
def test_track_terms_equal_the_einsums(dtype, shared, views):
    """CPU tensors: the PCG path's terms, rhs and back-substitution
    tensors bit for bit what its inline einsums gave (a fifth of the
    points frozen)."""
    prob = _problem(views, dtype, shared)
    assert bool((prob.point_mut == 0).any())
    cfg = LMConfig(cg_iterations=10)
    plans = lm.make_plans(prob, cfg, False)
    terms, rhs, aux = lm._track_terms(prob, 1e-3, cfg, plans)
    want = _old_track_terms(prob, 1e-3, cfg, plans)
    got = dict(terms, rhs=rhs, g_pt=aux["g_pt"])
    assert set(got) == set(want)
    assert aux["W"] is terms["W"] and aux["Hpp_inv"] is terms["Hpp_inv"]
    for name, w in want.items():
        assert got[name].dtype == dtype, name
        assert torch.equal(got[name], w), name


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what `reduce_slots` reads
    to pick its branch."""
    @property
    def device(self):
        return torch.device("cuda", 0)


def _args(prob, wrap=None):
    args = list(_slots(prob)) + [prob.point_mut]
    return [t.as_subclass(wrap) for t in args] if wrap else args


def test_card_tensors_never_reach_the_plain_version(monkeypatch):
    """Slots on the card go to the kernel's launch with the damping, and
    never to the einsums."""
    def no_plain(*args):
        raise AssertionError("the plain version reached with card tensors")

    calls = []

    def launch(*args):
        calls.append(args)
        return "kernel's result"

    monkeypatch.setattr(ba_reduce_slots, "reduce_slots_plain", no_plain)
    monkeypatch.setattr(ba_reduce_slots, "_launch", launch)
    prob = _problem(4, torch.float32, n_pts=20)
    args = _args(prob, _OnCard)
    assert ba_reduce_slots.reduce_slots(*args, 2.5) == "kernel's result"
    (got,) = calls
    assert all(a is b for a, b in zip(got, args)) and got[-1] == 2.5


def test_other_devices_raise(monkeypatch):
    def no_plain(*args):
        raise AssertionError("the plain version reached")

    monkeypatch.setattr(ba_reduce_slots, "reduce_slots_plain", no_plain)
    args = [t.to("meta") for t in _args(_problem(4, n_pts=20))]
    with pytest.raises(ValueError, match="meta"):
        ba_reduce_slots.reduce_slots(*args, 1e-3)


@pytest.mark.parametrize("case,error", [
    ("half", TypeError), ("mixed", TypeError), ("int point_mut", TypeError),
    ("tensor lam", TypeError), ("r shape", ValueError),
    ("Jpo width", ValueError), ("Jpt views", ValueError),
    ("point_mut shape", ValueError), ("two devices", ValueError)])
def test_wrapper_checks_arguments(case, error):
    """Wrong types, shapes and devices raise before any work."""
    a = _args(_problem(4, torch.float32, n_pts=20))
    lam = 1e-3
    if case == "half":
        a = [t.half() for t in a]
    elif case == "mixed":
        a[1] = a[1].double()
    elif case == "int point_mut":
        a[4] = a[4].long()
    elif case == "tensor lam":
        lam = torch.tensor(1e-3)
    elif case == "r shape":
        a[0] = a[0][..., :1]
    elif case == "Jpo width":
        a[1] = a[1][..., :5]
    elif case == "Jpt views":
        a[3] = a[3][:, :-1]
    elif case == "point_mut shape":
        a[4] = a[4][:-1]
    elif case == "two devices":
        a[4] = a[4].to("meta")
    before = ba_reduce_slots.reduce_slots.launches
    with pytest.raises(error):
        ba_reduce_slots.reduce_slots(*a, lam)
    assert ba_reduce_slots.reduce_slots.launches == before


# -- the kernel itself: on the card only --------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the reduce kernel runs only on the "
                    "card")
    return torch.device("cuda")


def check_kernel(got, plain, truth, where, dtype):
    """float64: every output within 1e-12 of its largest entry of the
    plain version (the same expressions, rounded at other places: FMA
    contraction, the order of the point sums).  float32: no less accurate
    than the float32 plain version against the float64 truth, within
    twice its error and 1e-6 of the largest entry (the inverse amplifies
    either's rounding by the point block's condition number)."""
    errs = chip_smoke.reduce_slots_errors(got, plain, truth, where)
    for name, (ek, ep) in errs.items():
        if dtype == torch.float64:
            assert ek <= 1e-12, (name, ek, ep)
        else:
            assert ek <= 2 * ep + 1e-6, (name, ek, ep)
    return errs


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("views", [1, 3, 16, 40, 300])
@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_kernel_on_the_card(dtype, views, lam):
    """The kernel against the plain version on the same slots, at V from
    1 to 300 (past a block's 256 / 128 threads, so one point's slots span
    several runs of a block); 2,048 points, a fifth frozen, 60 % of the
    slots kept; bit-equal over repeats; masked slots zero.  Needs an
    NVIDIA GPU: `python -m pytest tests/test_torch_ba_reduce_slots.py -q
    -m card` on the card."""
    dev = _card()
    prob = _problem(views, dtype, n_pts=2048 if views <= 40 else 256,
                    seed=3, dev=dev)
    slots = _slots(prob)
    before = ba_reduce_slots.reduce_slots.launches
    got = [ba_reduce_slots.reduce_slots(*slots, prob.point_mut, lam)
           for _ in range(2)]
    assert ba_reduce_slots.reduce_slots.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*got))
    got = got[0]
    assert all(g.is_contiguous() and g.dtype == dtype for g in got)
    pm = prob.point_mut.to(dtype)
    plain = ba_reduce_slots.reduce_slots_plain(*slots, pm, lam)
    truth = ba_reduce_slots.reduce_slots_plain(
        *(s.double() for s in slots), pm.double(), lam)
    check_kernel(got, plain, truth, prob.track_mask, dtype)
    for g in got[2:]:
        assert bool((g[~prob.track_mask] == 0).all())


def _plain(r, Jpo, Jin, Jpt, point_mut, lam):
    """reduce_slots with the plain version on any device."""
    return ba_reduce_slots.reduce_slots_plain(r, Jpo, Jin, Jpt,
                                              point_mut.to(r.dtype), lam)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [True, False])
def test_system_on_the_card(dtype, shared, monkeypatch):
    """S and rhs of partial_camera_system at the BA cell's widths (64
    cameras, V = 16, 8,192 points, one camera model or one a camera),
    kernel against the plain version on the card: float64 within 1e-12 of
    the largest entry; float32 within twice the plain version's error
    against the float64 system and 1e-6 of its largest entry."""
    dev = _card()
    prob = chip_smoke.linearize_problem(dev, 8192, dtype, seed=4,
                                        shared=shared)
    p64 = prob._replace(**{k: getattr(prob, k).double() for k in
                           ("poses", "intrs", "points", "track_uv",
                            "track_weight")})
    plans = lm.make_plans(prob, LMConfig(), False)
    got = lm.partial_camera_system(prob, 1e-3, LMConfig(), plans)
    monkeypatch.setattr(ba_reduce_slots, "reduce_slots", _plain)
    plain = lm.partial_camera_system(prob, 1e-3, LMConfig(), plans)
    truth = lm.partial_camera_system(p64, 1e-3, LMConfig(), plans)
    for k, p, t in zip(got[:2], plain[:2], truth[:2]):
        scale = float(t.abs().max())
        ek = float((k.double() - t).abs().max()) / scale
        ep = float((p.double() - t).abs().max()) / scale
        if dtype == torch.float64:
            assert ek <= 1e-12, (ek, ep)
        else:
            assert ek <= 2 * ep + 1e-6, (ek, ep)


@pytest.mark.card
def test_solve_lm_on_the_card(monkeypatch):
    """solve_lm at the cell's widths (dense Schur, 64 cameras, V = 16)
    with the kernel and with the plain version forced: the same final
    cost within 1e-5 relative, iteration counts within one; two solves
    with the kernel give the same bits."""
    dev = _card()
    prob = synth.synthetic_ba_problem(64, 32768, 16, seed=11, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    prob = prob._replace(track_uv=prob.track_uv + 0.5 * torch.randn(
        prob.track_uv.shape, generator=g, device=dev))
    cfg = LMConfig(max_iterations=15, rtol=1e-4)
    before = ba_reduce_slots.reduce_slots.launches
    ok, ik = lm.solve_lm(prob, cfg)
    assert ba_reduce_slots.reduce_slots.launches - before == ik["iterations"]
    again, ia = lm.solve_lm(prob, cfg)
    assert ia == ik
    assert torch.equal(ok.poses, again.poses)
    assert torch.equal(ok.points, again.points)
    assert torch.equal(ok.intrs, again.intrs)
    monkeypatch.setattr(ba_reduce_slots, "reduce_slots", _plain)
    _, ip = lm.solve_lm(prob, cfg)
    assert ik["final_cost"] < ik["initial_cost"]
    assert abs(ik["final_cost"] - ip["final_cost"]) \
        <= 1e-5 * ip["final_cost"], (ik, ip)
    assert abs(ik["iterations"] - ip["iterations"]) <= 1


@pytest.mark.card
def test_pcg_solve_lm_on_the_card(monkeypatch):
    """solve_lm with the PCG camera solve at the cell's widths (64
    cameras, V = 16, 32,768 points; CG to 1e-6, no forcing), which
    reduces through the kernel too: one launch an LM iteration; two
    solves give the same bits; the plain version forced gives the final
    cost within 1e-5 relative and the iteration count within one."""
    dev = _card()
    prob = synth.synthetic_ba_problem(64, 32768, 16, seed=12, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    prob = prob._replace(track_uv=prob.track_uv + 0.5 * torch.randn(
        prob.track_uv.shape, generator=g, device=dev))
    cfg = LMConfig(max_iterations=15, rtol=1e-4, cg_iterations=100,
                   cg_tol=1e-6, cg_forcing=False)
    before = ba_reduce_slots.reduce_slots.launches
    ok, ik = lm.solve_lm(prob, cfg)
    assert ba_reduce_slots.reduce_slots.launches - before == ik["iterations"]
    again, ia = lm.solve_lm(prob, cfg)
    assert ia == ik
    assert torch.equal(ok.poses, again.poses)
    assert torch.equal(ok.points, again.points)
    monkeypatch.setattr(ba_reduce_slots, "reduce_slots", _plain)
    _, ip = lm.solve_lm(prob, cfg)
    assert ik["final_cost"] < ik["initial_cost"]
    assert abs(ik["final_cost"] - ip["final_cost"]) \
        <= 1e-5 * ip["final_cost"], (ik, ip)
    assert abs(ik["iterations"] - ip["iterations"]) <= 1
