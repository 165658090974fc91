"""The generators make the same inputs from the same seed."""
import torch

from sfmbench.core import spec
from sfmbench.gen import survey
from sfmbench.traffic import ba_solves

BIG = 2 ** 31 + 977          # seeds may exceed 32 signed bits


def tiny_survey():
    s = dict(spec.load_json("configs", "uav_survey")["survey"])
    s.update(grid=[4, 5], obs_per_view=200)
    return s


def test_survey_is_deterministic():
    a = survey.make_survey(tiny_survey(), BIG, "cpu")
    b = survey.make_survey(tiny_survey(), BIG, "cpu")
    c = survey.make_survey(tiny_survey(), BIG + 1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # another seed: the same site and sizes, other noise
    for k in ("poses", "intr", "points", "track_cam", "track_mask"):
        assert torch.equal(a[k], c[k]), k
    assert not torch.equal(a["track_uv"], c["track_uv"])


def test_survey_shape():
    s = tiny_survey()
    sv = survey.make_survey(s, BIG, "cpu")
    C = s["grid"][0] * s["grid"][1]
    assert sv["poses"].shape == (C, 6)
    n = sv["track_mask"].sum(dim=1)
    assert int(n.min()) >= 2 and int(n.max()) <= s["max_views"]
    # every kept observation lies inside its image
    uv = sv["track_uv"][sv["track_mask"]]
    assert float(uv[:, 0].abs().max()) < s["width"] / 2 + 5
    assert float(uv[:, 1].abs().max()) < s["height"] / 2 + 5


def test_starts_and_partial_problems_are_deterministic():
    cell = spec.cell("uav_local_ba400")
    sv = survey.make_survey(tiny_survey(), BIG, "cpu")
    settings = cell["config_spec"]["settings"]
    mix = dict(cell["mix"], around_views=4)
    p1 = ba_solves.partial_problems(sv, settings, mix)
    p2 = ba_solves.partial_problems(sv, settings, mix)
    assert [p.C for p in p1] == [p.C for p in p2]
    for a, b in zip(p1, p2):
        assert torch.equal(a.track_cam, b.track_cam)
        assert not bool(a.pose_free.all())      # a frozen anchor or gauge
        sa = a.start(cell["config_spec"]["start"], BIG, 3)
        sb = b.start(cell["config_spec"]["start"], BIG, 3)
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))
        sc = a.start(cell["config_spec"]["start"], BIG, 4)
        assert not torch.equal(sa[2], sc[2])


def test_around_views_spread_over_the_survey():
    v = ba_solves.around_views(400, 64)
    assert len(v) == 64 and v[0] == 0 and v[-1] == 399
