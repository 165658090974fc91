"""Parity of the port's 2-NN matcher with the JAX package.

The port's knn2 runs its plain PyTorch version here (CPU tensors); the JAX
side runs matching.knn2 (XLA) and the Pallas kernel in interpret mode, as
tests/test_matching_sift.py does.  Bar (test_matching_sift.py:121-124):
index agreement > 0.999, d^2 within 2e-2.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import matching as jm
from metricsfm_tpu.ops.pallas.match_kernel import knn2_pallas
from metricsfm_tpu_torch.ops import matching as tm
from tests.torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def unit_rows(rng, *shape):
    x = rng.normal(size=shape + (128,)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    d1, d2 = unit_rows(rng, 300), unit_rows(rng, 500)
    mask2 = np.ones(500, bool)
    mask2[450:] = False
    return d1, d2, mask2


def _agree(ref, port):
    r1, r2, ridx = (np.asarray(x) for x in ref)
    p1, p2, pidx = (x.numpy() for x in port)
    assert float((ridx == pidx).mean()) > 0.999
    np.testing.assert_allclose(p1, r1, atol=2e-2)
    np.testing.assert_allclose(p2, r2, atol=2e-2)
    return pidx


def test_knn2_matches_xla():
    d1, d2, mask2 = _pair()
    port = tm.knn2(torch.tensor(d1), torch.tensor(d2), torch.tensor(mask2))
    pidx = _agree(jm.knn2(jnp.asarray(d1), jnp.asarray(d2),
                          jnp.asarray(mask2)), port)
    assert pidx.max() < 450                      # mask respected


def test_knn2_matches_pallas_interpret():
    d1, d2, mask2 = _pair(1)
    port = tm.knn2(torch.tensor(d1), torch.tensor(d2), torch.tensor(mask2))
    _agree(knn2_pallas(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask2),
                       tile=128, interpret=True), port)


def test_knn2_edge_cases():
    """One valid column: d2 = inf; duplicate best: lowest column, second ==
    best; ragged N across several chunks."""
    rng = np.random.default_rng(2)
    d1, d2 = unit_rows(rng, 40), unit_rows(rng, 70)
    m = np.zeros(70, bool)
    m[33] = True
    a1, a2, ai = tm.knn2(torch.tensor(d1), torch.tensor(d2), torch.tensor(m))
    assert torch.all(ai == 33) and torch.all(torch.isinf(a2))
    assert torch.all(torch.isfinite(a1))
    d2[50] = d2[12]
    d1[:5] = d2[12]
    b1, b2, bi = tm.knn2(torch.tensor(d1), torch.tensor(d2))
    assert torch.all(bi[:5] == 12) and torch.equal(b1[:5], b2[:5])
    # chunked scan (several column blocks, ragged tail) == one block
    store = torch.tensor(unit_rows(rng, 2, 1000)).to(torch.bfloat16)
    mask = torch.tensor(rng.uniform(size=(2, 1000)) > 0.2)
    ii = torch.tensor([0, 1], dtype=torch.int32)
    jj = torch.tensor([1, 0], dtype=torch.int32)
    one = tm.knn2_reference(store, mask, ii, jj, chunk=1000)
    many = tm.knn2_reference(store, mask, ii, jj, chunk=96)
    assert torch.equal(one[2], many[2])
    torch.testing.assert_close(one[0], many[0], atol=1e-6, rtol=0)


def test_match_pair_parity():
    rng = np.random.default_rng(3)
    base = unit_rows(rng, 200)
    d2 = base + rng.normal(size=base.shape).astype(np.float32) * 0.02
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    perm = rng.permutation(200)
    rj = jm.match_pair(jnp.asarray(base), jnp.asarray(d2[perm]))
    rt = tm.match_pair(torch.tensor(base), torch.tensor(d2[perm]))
    for k in ("idx2", "good", "all"):
        assert (np.asarray(rj[k]) == rt[k].numpy()).mean() > 0.999, k
    good = rt["good"].numpy()
    assert good.sum() > 150
    assert (rt["idx2"].numpy()[good] == np.argsort(perm)[good]).mean() > 0.99


def test_gather_batch_equals_per_pair():
    """knn2_gather over a store == knn2 of each pair separately."""
    rng = np.random.default_rng(4)
    store = unit_rows(rng, 4, 256)
    mask = rng.uniform(size=(4, 256)) > 0.1
    ii = np.array([0, 1, 2, 3, 0], np.int32)
    jj = np.array([1, 2, 3, 0, 2], np.int32)
    st = torch.tensor(store).to(torch.bfloat16)
    g1, g2, gi = tm.knn2_gather(st, torch.tensor(mask), torch.tensor(ii),
                                torch.tensor(jj))
    for b in range(len(ii)):
        p1, p2, pi = tm.knn2(torch.tensor(store[ii[b]]),
                             torch.tensor(store[jj[b]]),
                             torch.tensor(mask[jj[b]]))
        assert torch.equal(gi[b], pi)
        torch.testing.assert_close(g1[b], p1, atol=1e-6, rtol=0)
        torch.testing.assert_close(g2[b], p2, atol=1e-6, rtol=0)


def test_match_pairs_batch_parity():
    rng = np.random.default_rng(5)
    d1, d2 = unit_rows(rng, 3, 128), unit_rows(rng, 3, 128)
    m1 = rng.uniform(size=(3, 128)) > 0.1
    m2 = rng.uniform(size=(3, 128)) > 0.1
    rj = jm.match_pairs_batch(jnp.asarray(d1), jnp.asarray(d2),
                              jnp.asarray(m1), jnp.asarray(m2))
    rt = tm.match_pairs_batch(torch.tensor(d1), torch.tensor(d2),
                              torch.tensor(m1), torch.tensor(m2))
    for k in ("idx2", "good", "all"):
        assert (np.asarray(rj[k]) == rt[k].numpy()).mean() > 0.999, k
    np.testing.assert_allclose(rt["dist_sq"].numpy(),
                               np.asarray(rj["dist_sq"]), atol=2e-2)


def test_mutual_filter_parity():
    rng = np.random.default_rng(6)
    i12 = rng.integers(0, 50, 60)
    i21 = rng.integers(0, 60, 50)
    m = rng.uniform(size=60) > 0.3
    np.testing.assert_array_equal(
        np.asarray(jm.mutual_filter(jnp.asarray(i12), jnp.asarray(i21),
                                    jnp.asarray(m))),
        tm.mutual_filter(torch.tensor(i12), torch.tensor(i21),
                         torch.tensor(m)).numpy())


def test_wrapper_uses_plain_version_on_cpu():
    """A CPU tensor goes to knn2_reference and launches no kernel."""
    rng = np.random.default_rng(7)
    st = torch.tensor(unit_rows(rng, 2, 200)).to(torch.bfloat16)
    mask = torch.ones((2, 200), dtype=torch.bool)
    ii = torch.tensor([0], dtype=torch.int32)
    before = tm.knn2_gather.launches
    out = tm.knn2_gather(st, mask, ii, ii + 1)
    ref = tm.knn2_reference(st, mask, ii, ii + 1)
    assert tm.knn2_gather.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["f32 store", "D=64", "int64 ii", "mask"])
def test_wrapper_validates_arguments(bad):
    st = torch.zeros((2, 64, 128), dtype=torch.bfloat16)
    mask = torch.ones((2, 64), dtype=torch.bool)
    ii = torch.tensor([0], dtype=torch.int32)
    jj = ii + 1
    if bad == "f32 store":
        st = st.float()
    elif bad == "D=64":
        st = st[..., :64]
    elif bad == "int64 ii":
        ii = ii.long()
    else:
        mask = mask[:, :32]
    with pytest.raises((TypeError, ValueError)):
        tm.knn2_gather(st, mask, ii, jj)


def test_module_imports_without_nvcc():
    """Importing the matcher builds nothing; asking for the kernel without
    nvcc raises instead of falling back."""
    code = (
        "import sys, metricsfm_tpu_torch.ops.matching as m\n"
        "from metricsfm_tpu_torch.ops import cuda_build\n"
        "assert cuda_build._loaded == {}\n"
        "try:\n"
        "    cuda_build.load_library('knn2')\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "    print('raised')\n")
    env = dict(os.environ, PATH="", PYTHONPATH=REPO, CUDA_HOME="/nonexistent",
               CUDA_PATH="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "raised" in out.stdout


@pytest.mark.parametrize("bad", ["negative ii", "jj == M"])
def test_gather_rejects_pair_index_out_of_range(bad):
    """An index outside [0, M) raises on the CPU path (the card queues the
    same check without a host sync) and launches nothing."""
    st = torch.zeros((3, 64, 128), dtype=torch.bfloat16)
    mask = torch.ones((3, 64), dtype=torch.bool)
    ii = torch.tensor([0, 1], dtype=torch.int32)
    jj = torch.tensor([1, 2], dtype=torch.int32)
    if bad == "negative ii":
        ii = torch.tensor([0, -1], dtype=torch.int32)
    else:
        jj = torch.tensor([1, 3], dtype=torch.int32)
    before = tm.knn2_gather.launches
    with pytest.raises(IndexError):
        tm.knn2_gather(st, mask, ii, jj)
    assert tm.knn2_gather.launches == before


def emulate_kernel_2a(sim, valid):
    """A numpy model of the algorithm that knn2.cu folds with (it does not
    run the kernel): 128-column tiles, as the kernel's kBN, a bias of -inf
    on masked columns and on columns at or past N (the tile there reads the
    next image); the lane q4 of a row sees columns 8 j + 2 q4 + e in
    increasing order with second = max(second, min(best, v)), a strict
    v > best for the index; each tile's top-2 folds into the running one,
    then the four lanes merge."""
    n1, n2 = sim.shape
    lanes = []
    for q4 in range(4):
        best = np.full(n1, -np.inf, np.float32)
        second = np.full(n1, -np.inf, np.float32)
        idx = np.zeros(n1, np.int64)
        for n0 in range(0, n2, 128):
            tb = np.full(n1, -np.inf, np.float32)
            ts = np.full(n1, -np.inf, np.float32)
            ti = np.zeros(n1, np.int64)
            for j in range(16):
                for e in range(2):
                    c = n0 + 8 * j + 2 * q4 + e
                    ok = c < n2 and valid[c]
                    # past N: the next image's rows, ruled out by the bias
                    v = sim[:, c] if ok else np.full(n1, -np.inf, np.float32)
                    ts = np.maximum(ts, np.minimum(tb, v))
                    ti = np.where(v > tb, c, ti)
                    tb = np.maximum(tb, v)
            up = tb > best
            second = np.where(up, np.maximum(best, ts),
                              np.maximum(second, tb))
            idx = np.where(up, ti, idx)
            best = np.where(up, tb, best)
        lanes.append((best, second, idx))
    best, second, idx = lanes[0]
    for ob, os_, oi in lanes[1:]:
        take = (ob > best) | ((ob == best) & (oi < idx))
        second = np.where(take, np.maximum(best, os_),
                          np.maximum(second, ob))
        idx = np.where(take, oi, idx)
        best = np.where(take, ob, best)
    return (np.maximum(2 - 2 * best, 0), np.maximum(2 - 2 * second, 0), idx)


@pytest.mark.parametrize("case", ["ragged masked", "one column",
                                  "all masked", "masked tile", "ties"])
def test_kernel_2a_fold_equals_plain_version(case):
    """The tile fold of kernel 2a's design, modelled in numpy on the same
    f32 similarities, equals knn2_reference: idx, d1^2 and d2^2 exactly
    (the kernel itself is held to its plain version on the card)."""
    rng = np.random.default_rng(12)
    n = 300
    store = unit_rows(rng, 2, n)
    mask = rng.uniform(size=(2, n)) > 0.2
    if case == "one column":
        mask[1] = False
        mask[1, 131] = True
    elif case == "all masked":
        mask[1] = False
    elif case == "masked tile":
        mask[1, 128:256] = False
    elif case == "ties":
        mask[1] = True
        store[1, 250] = store[1, 129] = store[1, 3]
        store[0, :5] = store[1, 3]
    st = torch.tensor(store).to(torch.bfloat16)
    ii = torch.tensor([0], dtype=torch.int32)
    want = [t[0].numpy() for t in
            tm.knn2_reference(st, torch.tensor(mask), ii, ii + 1)]
    q = st.float()
    # the reference's own product shape, so both see the same f32 sums
    sim = torch.matmul(q[:1], q[1:].transpose(1, 2))[0].numpy()
    got = emulate_kernel_2a(sim, mask[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if case == "ties":
        assert np.all(got[2][:5] == 3) and np.all(got[0][:5] == got[1][:5])
