"""ops/homography of the PyTorch port against the JAX package on the same
inputs: the normalized DLT, the transfer error, and the batched 4-point
RANSAC with the JAX package's own samples injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import homography as jh
from metricsfm_tpu_torch.ops import homography as th
from tests.torch_threads import torch_threads  # noqa: F401


def _true_h(rng):
    H = np.eye(3) + rng.normal(0, 0.05, (3, 3))
    H[:2, 2] = rng.uniform(-40, 40, 2)
    H[2, :2] = rng.normal(0, 2e-4, 2)
    return H / H[2, 2]


def _apply(H, p):
    q = np.concatenate([p, np.ones((len(p), 1))], 1) @ H.T
    return q[:, :2] / q[:, 2:]


def _norm(H):
    H = np.asarray(H, np.float64)
    return H / H[..., 2:3, 2:3]


def _dlt_case(n):
    rng = np.random.default_rng(n)
    p1 = rng.uniform(-300, 300, (n, 2))
    p2 = _apply(_true_h(rng), p1) + rng.normal(0, 0.5, (n, 2))
    return p1, p2, rng.uniform(0.2, 1.0, n)


@pytest.mark.parametrize("n", [4, 200])
def test_dlt_and_transfer_error_match_jax(n):
    """f32, as the pipeline runs them: H within 1e-4 of JAX's relative to
    its largest entry (the 9x9 eigh solves differ in f32 rounding), and
    the transfer errors within 1e-3 px."""
    p1, p2, w = (a.astype(np.float32) for a in _dlt_case(n))
    for weights in (None, w):
        Hj = jh.homography_dlt(jnp.asarray(p1), jnp.asarray(p2),
                               None if weights is None else jnp.asarray(w))
        Ht = th.homography_dlt(torch.tensor(p1), torch.tensor(p2),
                               None if weights is None else torch.tensor(w))
        Hj_, Ht_ = _norm(Hj), _norm(Ht.numpy())
        assert np.abs(Ht_ - Hj_).max() <= 1e-4 * np.abs(Hj_).max()
        ej = np.asarray(jh.transfer_error(Hj, jnp.asarray(p1),
                                          jnp.asarray(p2)))
        et = th.transfer_error(Ht, torch.tensor(p1), torch.tensor(p2))
        np.testing.assert_allclose(et.numpy(), ej, atol=1e-3)


@pytest.mark.parametrize("n", [4, 200])
def test_dlt_matches_jax_in_f64(n):
    """The same algebra in f64 (x64 on the JAX side): every entry of H
    within 1e-4 absolute."""
    p1, p2, w = _dlt_case(n)
    with jax.enable_x64(True):
        for weights in (None, w):
            Hj = np.asarray(jh.homography_dlt(
                jnp.asarray(p1), jnp.asarray(p2),
                None if weights is None else jnp.asarray(w)))
            Ht = th.homography_dlt(
                torch.tensor(p1), torch.tensor(p2),
                None if weights is None else torch.tensor(w))
            np.testing.assert_allclose(_norm(Ht.numpy()), _norm(Hj),
                                       atol=1e-4)


def test_transfer_error_floors_w_as_jax():
    """|w| < 1e-12 becomes +1e-12 in both packages: a point mapped to the
    line at infinity gives the same (huge) finite error."""
    H = np.array([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]], np.float32)
    p1 = np.array([[0.0, 5.0], [2.0, 1.0]], np.float32)
    p2 = np.zeros((2, 2), np.float32)
    ej = np.asarray(jh.transfer_error(jnp.asarray(H), jnp.asarray(p1),
                                      jnp.asarray(p2)))
    et = th.transfer_error(torch.tensor(H), torch.tensor(p1),
                           torch.tensor(p2)).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-6)
    assert np.isfinite(et).all() and et[0] > 1e12


def _jax_samples(key, mask, num_hypotheses=256):
    """JAX homography_ransac's own draws (ops/homography.py:57-60)."""
    N = mask.shape[0]
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    keys = jax.random.split(key, num_hypotheses)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(4,), replace=False, p=jax.nn.softmax(logits)))(keys))


def _ransac_pair(seed, n_valid=150, n_pad=42, outlier_frac=0.3):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-300, 300, (n_valid, 2))
    p2 = _apply(_true_h(rng), p1) + rng.normal(0, 0.4, (n_valid, 2))
    bad = rng.uniform(size=n_valid) < outlier_frac
    p2[bad] = rng.uniform(-300, 300, (int(bad.sum()), 2))
    p1 = np.concatenate([p1, np.zeros((n_pad, 2))]).astype(np.float32)
    p2 = np.concatenate([p2, np.zeros((n_pad, 2))]).astype(np.float32)
    mask = np.arange(n_valid + n_pad) < n_valid
    return p1, p2, mask


def test_ransac_matches_jax_with_injected_samples():
    """Two pairs in one batched call, each with 30 % outliers and padded
    rows, fed JAX's draws: the same H, inlier masks and ok."""
    pairs = [_ransac_pair(s) for s in (1, 2)]
    keys = jax.random.split(jax.random.PRNGKey(7), len(pairs))
    jres, samples = [], []
    for (p1, p2, m), k in zip(pairs, keys):
        jres.append(jh.homography_ransac(jnp.asarray(p1), jnp.asarray(p2), k,
                                         mask=jnp.asarray(m), th_px=3.0))
        samples.append(_jax_samples(k, m))
    st = lambda i: torch.tensor(np.stack([p[i] for p in pairs]))  # noqa: E731
    tres = th.homography_ransac(st(0), st(1), mask=st(2), th_px=3.0,
                                sample_idx=torch.tensor(np.stack(samples)))
    for b, jr in enumerate(jres):
        Hj, Ht = _norm(jr["H"]), _norm(tres["H"][b].numpy())
        assert np.abs(Ht - Hj).max() <= 1e-3 * np.abs(Hj).max()
        agree = (tres["inlier_mask"][b].numpy()
                 == np.asarray(jr["inlier_mask"])).mean()
        assert agree >= 0.99, agree
        assert bool(tres["ok"][b]) == bool(jr["ok"])
        assert int(tres["n_inliers"][b]) >= 0.6 * pairs[b][2].sum()
        assert not tres["inlier_mask"][b][~torch.tensor(pairs[b][2])].any()


def test_ransac_draws_from_generator():
    """Without injected samples the port draws from its Generator: one seed
    gives one result, and a clean pair is recovered."""
    p1, p2, m = _ransac_pair(3, outlier_frac=0.0)
    args = (torch.tensor(p1)[None], torch.tensor(p2)[None])
    out = [th.homography_ransac(*args, torch.Generator().manual_seed(5),
                                mask=torch.tensor(m)[None])
           for _ in range(2)]
    assert torch.equal(out[0]["inlier_mask"], out[1]["inlier_mask"])
    assert int(out[0]["n_inliers"][0]) >= 0.95 * m.sum()
    assert bool(out[0]["ok"][0])
