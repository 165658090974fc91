"""RANSAC parity with injected samples.

JAX's threefry stream and torch generators cannot give the same draws, so
each test draws the JAX package's minimal samples exactly as its RANSAC
does internally and injects them into the port (`sample_idx`); both sides
then score the same hypotheses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from metricsfm_tpu.ops import pnp as jpnp
from metricsfm_tpu.ops import ransac as jr
from metricsfm_tpu_torch.ops import pnp as tpnp
from metricsfm_tpu_torch.ops import ransac as tr
from tests.conftest import make_scene
from tests.torch_threads import torch_threads  # noqa: F401


def _matches(seed, n_pts=300, outlier_frac=0.3):
    rng = np.random.default_rng(seed)
    sc = make_scene(rng, n_cams=4, n_pts=n_pts, noise_px=0.5)
    p1 = sc["obs"][0].astype(np.float32)
    p2 = sc["obs"][2].astype(np.float32).copy()
    bad = rng.uniform(size=n_pts) < outlier_frac
    p2[bad] += rng.uniform(-200, 200, size=(bad.sum(), 2))
    mask = rng.uniform(size=n_pts) > 0.1
    return p1, p2, mask, bad


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < atol


def test_fundamental_ransac_injected_samples():
    p1, p2, mask, bad = _matches(0)
    key = jax.random.PRNGKey(3)
    rj = jr.fundamental_ransac(jnp.asarray(p1), jnp.asarray(p2), key,
                               mask=jnp.asarray(mask))
    # the exact samples fundamental_ransac drew from `key`
    idx = jr._sample_indices(key, len(p1), jnp.asarray(mask), 256, 8)
    rt = tr.fundamental_ransac(torch.tensor(p1), torch.tensor(p2),
                               mask=torch.tensor(mask),
                               sample_idx=torch.tensor(np.asarray(idx)))
    inl_j = np.asarray(rj["inlier_mask"])
    inl_t = rt["inlier_mask"].numpy()
    assert (inl_j == inl_t).mean() >= 0.99
    assert bool(rj["ok"]) and bool(rt["ok"])
    assert abs(int(rj["n_inliers"]) - int(rt["n_inliers"])) <= 3
    _same_up_to_sign(rj["F"], rt["F"], atol=1e-3)
    # and the inliers are the uncorrupted matches
    assert (inl_t[mask] == ~bad[mask]).mean() > 0.95


def test_fundamental_ransac_batched_pairs():
    """A leading pair axis equals per-pair calls (the verify batch form)."""
    data = [_matches(s) for s in (1, 2, 3)]
    p1 = torch.tensor(np.stack([d[0] for d in data]))
    p2 = torch.tensor(np.stack([d[1] for d in data]))
    m = torch.tensor(np.stack([d[2] for d in data]))
    idx = torch.stack([torch.tensor(np.asarray(jr._sample_indices(
        jax.random.PRNGKey(s), 300, jnp.asarray(d[2]), 64, 8)))
        for s, d in enumerate(data)])
    rb = tr.fundamental_ransac(p1, p2, mask=m, num_hypotheses=64,
                               sample_idx=idx)
    for b in range(3):
        r1 = tr.fundamental_ransac(p1[b], p2[b], mask=m[b], sample_idx=idx[b])
        assert (rb["inlier_mask"][b] == r1["inlier_mask"]).float().mean() \
            >= 0.99
        _same_up_to_sign(rb["F"][b], r1["F"], atol=1e-4)


def test_fundamental_ransac_generator_draws():
    """Drawing from a torch.Generator: valid rows only, distinct per
    hypothesis, reproducible from the seed."""
    _, _, mask, _ = _matches(4)
    g = torch.Generator().manual_seed(0)
    a = tr._sample_indices(g, torch.tensor(mask), 128, 8)
    g = torch.Generator().manual_seed(0)
    b = tr._sample_indices(g, torch.tensor(mask), 128, 8)
    assert torch.equal(a, b)
    assert mask[a.numpy()].all()
    srt = torch.sort(a, dim=1).values
    assert torch.all(srt[:, 1:] != srt[:, :-1])


def _pnp_problem(seed, n=200, focal=800.0):
    rng = np.random.default_rng(seed)
    sc = make_scene(rng, n_cams=3, n_pts=n, focal=focal, noise_px=0.5)
    Xw = sc["points"].astype(np.float32)
    obs = sc["obs"][1].astype(np.float32).copy()
    bad = rng.uniform(size=n) < 0.25
    obs[bad] += rng.uniform(-150, 150, size=(bad.sum(), 2))
    mask = np.ones(n, bool)
    mask[-20:] = False
    return Xw, obs, mask, sc


def _jax_p3p_samples(key, mask, n_hyp):
    """The samples pnp_ransac / pnp_ransac_unknown_focal draw from `key`."""
    m = jnp.asarray(mask)
    logits = jnp.where(m, 0.0, -1e9)
    keys = jax.random.split(key, n_hyp)
    return jax.vmap(lambda k: jax.random.choice(
        k, m.shape[0], shape=(3,), replace=False,
        p=jax.nn.softmax(logits)))(keys)


def test_pnp_ransac_unknown_focal_injected_samples():
    Xw, obs, mask, sc = _pnp_problem(5)
    key = jax.random.PRNGKey(7)
    rj = jpnp.pnp_ransac_unknown_focal(
        jnp.asarray(Xw), jnp.asarray(obs), 960.0, key,
        mask=jnp.asarray(mask), num_hypotheses=64, num_focal_samples=64)
    idx = np.asarray(_jax_p3p_samples(key, mask, 64))
    rt = tpnp.pnp_ransac_unknown_focal(
        torch.tensor(Xw), torch.tensor(obs), 960.0, mask=torch.tensor(mask),
        num_hypotheses=64, num_focal_samples=64,
        sample_idx=torch.tensor(idx))
    assert (np.asarray(rj["inlier_mask"]) == rt["inlier_mask"].numpy()
            ).mean() >= 0.99
    np.testing.assert_allclose(float(rt["f"]), float(rj["f"]), rtol=1e-5)
    np.testing.assert_allclose(rt["R"].numpy(), np.asarray(rj["R"]),
                               atol=1e-3)
    np.testing.assert_allclose(rt["t"].numpy(), np.asarray(rj["t"]),
                               atol=1e-2)
    # and the pose is the scene's camera 1
    from metricsfm_tpu_torch.ops import lie
    R_gt = lie.angle_axis_to_matrix(torch.tensor(sc["poses"][1, :3]))
    assert torch.abs(rt["R"].double() - R_gt).max() < 2e-2


def test_pnp_ransac_known_focal_injected_samples():
    Xw, obs, mask, _ = _pnp_problem(6)
    key = jax.random.PRNGKey(8)
    rj = jpnp.pnp_ransac(jnp.asarray(Xw), jnp.asarray(obs), 800.0, key,
                         mask=jnp.asarray(mask), num_hypotheses=128)
    idx = np.asarray(_jax_p3p_samples(key, mask, 128))
    rt = tpnp.pnp_ransac(torch.tensor(Xw), torch.tensor(obs), 800.0,
                         mask=torch.tensor(mask), num_hypotheses=128,
                         sample_idx=torch.tensor(idx))
    assert (np.asarray(rj["inlier_mask"]) == rt["inlier_mask"].numpy()
            ).mean() >= 0.99
    np.testing.assert_allclose(rt["R"].numpy(), np.asarray(rj["R"]),
                               atol=1e-3)
    np.testing.assert_allclose(rt["t"].numpy(), np.asarray(rj["t"]),
                               atol=1e-2)
    np.testing.assert_allclose(float(rt["avg_err"]), float(rj["avg_err"]),
                               atol=1e-2)


def test_p3p_grunert_parity():
    """Per minimal sample, the valid P3P solutions of both packages agree as
    sets (root slot order is not part of the contract)."""
    rng = np.random.default_rng(9)
    Xw, obs, _, sc = _pnp_problem(9)
    clean = make_scene(np.random.default_rng(9), n_cams=3, n_pts=200,
                       focal=800.0)["obs"][1].astype(np.float32)
    sel = np.stack([rng.choice(150, size=3, replace=False)
                    for _ in range(16)])
    bear = np.concatenate([clean / 800.0, np.ones_like(clean[:, :1])], 1)
    bear = (bear / np.linalg.norm(bear, axis=1, keepdims=True)).astype(
        np.float32)
    Rj, _, vj = jax.vmap(jpnp.p3p_grunert)(jnp.asarray(Xw[sel]),
                                           jnp.asarray(bear[sel]))
    Rt, _, vt = tpnp.p3p_grunert(torch.tensor(Xw[sel]),
                                 torch.tensor(bear[sel]))
    Rj, vj, Rt, vt = np.asarray(Rj), np.asarray(vj), Rt.numpy(), vt.numpy()
    assert (vj.sum(1) == vt.sum(1)).mean() >= 0.9
    # f32 quartic roots of ill-conditioned minimal samples differ in the
    # low digits between the two packages: most solutions agree closely,
    # none grossly
    ds = [np.abs(Rt[h][vt[h]] - r).max(axis=(1, 2)).min()
          for h in range(len(sel)) if vt[h].any() for r in Rj[h][vj[h]]]
    assert len(ds) >= 16
    assert np.median(ds) < 1e-3 and max(ds) < 5e-2, ds


def test_epnp_parity():
    Xw, obs, mask, _ = _pnp_problem(10)
    w = (mask & (np.random.default_rng(10).uniform(size=len(mask)) > 0.2)
         ).astype(np.float32)
    Rj, tj = jpnp.epnp(jnp.asarray(Xw), jnp.asarray(obs / 800.0),
                       jnp.asarray(w))
    Rt, tt = tpnp.epnp(torch.tensor(Xw), torch.tensor(obs / 800.0),
                       torch.tensor(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-2)
