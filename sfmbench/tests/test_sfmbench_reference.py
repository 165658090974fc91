"""The plain reference LM and its geometry."""
import torch

from sfmbench.reference import ba_lm, geometry

from test_sfmbench_gen import BIG, survey, tiny_survey


def test_tf32_rounding_keeps_11_significant_bits():
    x = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -12, 3 * 2.0 ** -11,
                      -1 - 3 * 2.0 ** -11])
    assert geometry.round_tf32(x).tolist() == [
        1.0, 1 + 2.0 ** -10, 1.0, 3 * 2.0 ** -11, -1 - 2 * 2.0 ** -10]


def test_analytic_jacobians_match_autograd():
    sv = survey.make_survey(tiny_survey(), BIG, "cpu")
    n = 6
    cam = sv["track_cam"][:n, 0]
    aa, t = sv["poses"][cam, :3], sv["poses"][cam, 3:]
    intr = sv["intr"].expand(n, 3).clone()
    X, uv = sv["points"][:n], sv["track_uv"][:n, 0]
    r, Jc, Jp = geometry.jacobians(aa, geometry.rotation(aa), t, intr, X, uv)

    def f(aa, t, intr, X):
        return geometry.residuals(geometry.rotation(aa), t, intr, X, uv)

    J = torch.autograd.functional.jacobian(f, (aa, t, intr, X))
    for i in range(n):
        Jcam = torch.cat([J[0][i, :, i], J[1][i, :, i], J[2][i, :, i]], 1)
        assert torch.allclose(Jcam, Jc[i], rtol=1e-9, atol=1e-6)
        assert torch.allclose(J[3][i, :, i], Jp[i], rtol=1e-9, atol=1e-9)
    assert torch.allclose(r, f(aa, t, intr, X))


def test_reference_lm_recovers_a_known_answer():
    """Noise-free observations: from a perturbed start the optimum is the
    truth, up to the scale about the gauge camera."""
    s = dict(tiny_survey(), noise_px=0.0)
    sv = survey.make_survey(s, BIG, "cpu")
    w = torch.ones(sv["points"].shape[0], dtype=torch.float64)
    obs = ba_lm.observations(sv["track_cam"], sv["track_uv"],
                             sv["track_mask"], w)
    g = torch.Generator().manual_seed(3)
    C = sv["poses"].shape[0]
    free = torch.ones(C, dtype=torch.bool)
    free[0] = False
    d = torch.randn(C, 6, generator=g, dtype=torch.float64) \
        * torch.tensor([1e-3] * 3 + [0.05] * 3, dtype=torch.float64)
    poses = sv["poses"] + d * free[:, None]
    intr = sv["intr"] * torch.tensor([1.004, 1, 1], dtype=torch.float64)
    points = sv["points"] + 0.05 * torch.randn(
        sv["points"].shape, generator=g, dtype=torch.float64)
    out = ba_lm.solve(obs, poses, intr, points, free, True, delta=1.0,
                      max_iterations=40, rtol=1e-14, init_lambda=1e-6)
    assert out[3]["cost"] < 1e-12 * out[3]["initial_cost"]
    gaps = ba_lm.gaps(obs, out[:3], (sv["poses"], sv["intr"],
                                     sv["points"]), 1.0, 0, out[3]["cost"])
    assert gaps["rot_gap_mdeg"] < 1e-3 and gaps["center_gap_mm"] < 1e-2
    assert gaps["point_gap_mm"] < 1e-2 and gaps["focal_gap_ppm"] < 1e-2
