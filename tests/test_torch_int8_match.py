"""Parity of the port's int8 2-NN (kernel 2b's contract) with the JAX package.

The port's knn2_int8 runs its plain PyTorch version here (CPU tensors);
the JAX side runs knn2_pallas_int8 in interpret mode.  The Pallas kernel
floors each value to 64-unit steps for its 13-bit column packing, so its
d^2 is within 64/65536 < 1/1024 of the exact one and its index can differ
only where the top-2 gap is below that step: on every row where its
d1_sq < d2_sq the index must agree.  Against an exact numpy 2-NN in the
same quantized space the port is equal, index and d^2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops.pallas.match_kernel import (
    knn2_pallas_int8, quantize_desc_int8 as jquant)
from metricsfm_tpu_torch.ops import matching as tm
from tests.torch_threads import torch_threads  # noqa: F401


def nonneg_unit(rng, *shape):
    x = np.abs(rng.normal(size=shape + (128,))).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def numpy_knn2_int8(d1, d2, mask2):
    """Exact 2-NN in quantized space, int64 numpy."""
    q = np.clip(np.round(d1 * 256), 0, 127).astype(np.int64)
    b = np.clip(np.round(d2 * 256), 0, 127).astype(np.int64)
    val = 2 * q @ b.T - (b * b).sum(1)[None, :]
    val = np.where(mask2[None, :], val, np.iinfo(np.int64).min)
    idx = np.argmax(val, axis=1)
    best = val[np.arange(len(q)), idx]
    val2 = val.copy()
    val2[np.arange(len(q)), idx] = np.iinfo(np.int64).min
    second = val2.max(axis=1)
    na = (q * q).sum(1)

    def dist(v):
        d = np.maximum(na - v, 0).astype(np.float64) / 65536.0
        return np.where(v == np.iinfo(np.int64).min, np.inf, d)
    return dist(best), dist(second), idx


def test_quantize_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    d = nonneg_unit(rng, 500)
    # exact half-steps and out-of-range values exercise rounding and clip
    d[0, :6] = np.array([0.5, 1.5, 2.5, 100.5, 127.5, 300.0]) / 256.0
    d[1, :3] = np.array([-0.2, 0.4999, 0.0], np.float32)
    want = np.asarray(jquant(jnp.asarray(d)))
    got = tm.quantize_desc_int8(torch.tensor(d)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["masked", "ragged", "one column",
                                  "all valid"])
def test_reference_equals_exact_numpy(case):
    rng = np.random.default_rng(1)
    n1, n2 = {"ragged": (301, 777)}.get(case, (200, 300))
    d1, d2 = nonneg_unit(rng, n1), nonneg_unit(rng, n2)
    mask2 = np.ones(n2, bool)
    if case in ("masked", "ragged"):
        mask2 = rng.uniform(size=n2) > 0.2
    elif case == "one column":
        mask2[:] = False
        mask2[117] = True
    want = numpy_knn2_int8(d1, d2, mask2)
    # several column chunks with a ragged tail
    got = tm.knn2_int8_reference(torch.tensor(d1), torch.tensor(d2),
                                 torch.tensor(mask2), chunk=128)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[0].numpy(), want[0].astype(np.float32))
    np.testing.assert_array_equal(got[1].numpy(), want[1].astype(np.float32))
    if case == "one column":
        assert np.all(got[2].numpy() == 117)
        assert np.all(np.isinf(got[1].numpy()))


def test_reference_tie_goes_to_lowest_column():
    rng = np.random.default_rng(2)
    d1, d2 = nonneg_unit(rng, 20), nonneg_unit(rng, 150)
    d2[140] = d2[33]
    d1[:4] = d2[33]
    d1_sq, d2_sq, idx = tm.knn2_int8(torch.tensor(d1), torch.tensor(d2))
    assert torch.all(idx[:4] == 33)
    assert torch.equal(d1_sq[:4], d2_sq[:4])


@pytest.mark.parametrize("case", ["masked", "ragged"])
def test_matches_pallas_int8_interpret(case):
    rng = np.random.default_rng(3)
    n1, n2 = (300, 1000) if case == "masked" else (257, 389)
    d1, d2 = nonneg_unit(rng, n1), nonneg_unit(rng, n2)
    mask2 = np.ones(n2, bool)
    if case == "masked":
        mask2[::7] = False
    j1, j2, jidx = (np.asarray(a) for a in knn2_pallas_int8(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask2), bq=128,
        interpret=True))
    p1, p2, pidx = (a.numpy() for a in tm.knn2_int8(
        torch.tensor(d1), torch.tensor(d2), torch.tensor(mask2)))
    np.testing.assert_allclose(p1, j1, atol=1.0 / 1024, rtol=0)
    np.testing.assert_allclose(p2, j2, atol=1.0 / 1024, rtol=0)
    clear = j1 < j2
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pidx[clear], jidx[clear])
    assert mask2[pidx].all()


def test_single_valid_column_gives_infinite_second():
    """The Pallas kernel returns a large finite d2 there; the port +inf."""
    rng = np.random.default_rng(4)
    d1, d2 = nonneg_unit(rng, 64), nonneg_unit(rng, 200)
    mask2 = np.zeros(200, bool)
    mask2[45] = True
    j1, j2, jidx = (np.asarray(a) for a in knn2_pallas_int8(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask2), bq=128,
        interpret=True))
    p1, p2, pidx = tm.knn2_int8(torch.tensor(d1), torch.tensor(d2),
                                torch.tensor(mask2))
    assert np.all(jidx == 45) and torch.all(pidx == 45)
    np.testing.assert_allclose(p1.numpy(), j1, atol=1.0 / 1024, rtol=0)
    assert torch.all(torch.isinf(p2)) and np.all(np.isfinite(j2))


def test_large_database_on_the_plain_version():
    """N2 > 8192, past the Pallas kernel's column cap."""
    rng = np.random.default_rng(5)
    d1, d2 = nonneg_unit(rng, 40), nonneg_unit(rng, 9000)
    mask2 = rng.uniform(size=9000) > 0.05
    want = numpy_knn2_int8(d1, d2, mask2)
    got = tm.knn2_int8(torch.tensor(d1), torch.tensor(d2),
                       torch.tensor(mask2))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[0].numpy(), want[0].astype(np.float32))
    np.testing.assert_array_equal(got[1].numpy(), want[1].astype(np.float32))
    assert want[2].max() >= 8192          # columns past the cap are reached


def test_pair_batch_equals_per_pair():
    rng = np.random.default_rng(6)
    d1, d2 = nonneg_unit(rng, 3, 150), nonneg_unit(rng, 3, 210)
    mask2 = rng.uniform(size=(3, 210)) > 0.1
    b1, b2, bi = tm.knn2_int8(torch.tensor(d1), torch.tensor(d2),
                              torch.tensor(mask2))
    assert b1.shape == (3, 150) and bi.dtype == torch.int32
    for p in range(3):
        s1, s2, si = tm.knn2_int8(torch.tensor(d1[p]), torch.tensor(d2[p]),
                                  torch.tensor(mask2[p]))
        assert torch.equal(bi[p], si)
        assert torch.equal(b1[p], s1) and torch.equal(b2[p], s2)


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(7)
    d1, d2 = torch.tensor(nonneg_unit(rng, 50)), torch.tensor(
        nonneg_unit(rng, 60))
    before = tm.knn2_int8.launches
    out = tm.knn2_int8(d1, d2)
    ref = tm.knn2_int8_reference(d1, d2)
    assert tm.knn2_int8.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # bf16 inputs quantize like their f32 values
    outb = tm.knn2_int8(d1.to(torch.bfloat16), d2)
    refb = tm.knn2_int8_reference(d1.to(torch.bfloat16).float(), d2)
    for a, b in zip(outb, refb):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["int8 input", "D=64", "rank mismatch",
                                 "mask shape", "mask dtype", "pair count"])
def test_wrapper_validates_arguments(bad):
    d1 = torch.zeros((2, 16, 128))
    d2 = torch.zeros((2, 24, 128))
    mask2 = torch.ones((2, 24), dtype=torch.bool)
    if bad == "int8 input":
        d1 = d1.to(torch.int8)
    elif bad == "D=64":
        d1, d2 = d1[..., :64], d2[..., :64]
    elif bad == "rank mismatch":
        d1 = d1[0]
    elif bad == "mask shape":
        mask2 = mask2[:, :10]
    elif bad == "mask dtype":
        mask2 = mask2.float()
    else:
        d2 = d2[:1]
        mask2 = mask2[:1]
    with pytest.raises((TypeError, ValueError)):
        tm.knn2_int8(d1, d2, mask2)


@pytest.mark.parametrize("bad", ["cpu tensors", "float operands",
                                 "bool mask", "strided", "mask shape"])
def test_kernel_entry_refuses_what_it_does_not_take(bad):
    """knn2_int8_kernel checks its operands before it builds or launches:
    CPU tensors never reach the CUDA kernel."""
    q8 = torch.zeros((2, 16, 128), dtype=torch.int8)
    db8 = torch.zeros((2, 24, 128), dtype=torch.int8)
    nq = torch.zeros((2, 16), dtype=torch.int32)
    nb = torch.zeros((2, 24), dtype=torch.int32)
    if bad == "float operands":
        q8 = q8.float()
    elif bad == "bool mask":         # a mask where the norms belong
        nb = torch.ones((2, 24), dtype=torch.bool)
    elif bad == "strided":
        db8 = torch.zeros((2, 24, 256), dtype=torch.int8)[..., ::2]
    elif bad == "mask shape":
        nb = nb[:, :10]
    before = tm.knn2_int8.launches
    with pytest.raises((TypeError, ValueError)):
        tm.knn2_int8_kernel(q8, db8, nq, nb)
    assert tm.knn2_int8.launches == before


def test_matching_throughput_runs_both_paths_on_cpu():
    """The throughput path's control flow at a toy size (its rates on the
    CPU say nothing about the card)."""
    out = tm.matching_throughput(n_pairs=2, n_kp=64, iters=2, device="cpu")
    assert set(out) == {"int8", "bf16"}
    assert all(v > 0 for v in out.values())
    d1, d2 = tm.throughput_descriptors(2, 64)
    assert d1.shape == (2, 64, 128) and (d1 >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(d2, axis=-1), 1.0, rtol=1e-5)


def boundary_descriptors(rng, n):
    """Non-negative unit rows with values on the .5 rounding boundary of
    256 x (exact in bf16 too), below zero and above the 127 clip."""
    d = nonneg_unit(rng, n)
    d[0, :8] = np.array([0.5, 1.5, 2.5, 3.5, 100.5, 126.5, 127.5, 300.0]) / 256
    d[1, :4] = np.array([-0.2, 0.4999, 0.0, 127.49 / 256], np.float32)
    d[2, :4] = np.array([64.5, 65.5, 9.5, 10.5]) / 256
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pass_plain_version_matches_jax(dtype):
    """The fused quantize pass's plain version is bit-equal to the JAX
    quantize_desc_int8 on f32 and bf16 inputs (half steps round to even)."""
    rng = np.random.default_rng(8)
    d = boundary_descriptors(rng, 300)
    x = torch.tensor(d)
    jx = jnp.asarray(d)
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
        jx = jx.astype(jnp.bfloat16)
    want = np.asarray(jquant(jx))
    q8, norms = tm.quantize_int8_reference(x)
    assert q8.dtype == torch.int8 and norms.dtype == torch.int32
    np.testing.assert_array_equal(q8.numpy(), want)
    assert q8[0, :8].tolist() == [0, 2, 2, 4, 100, 126, 127, 127]
    np.testing.assert_array_equal(
        norms.numpy(), (want.astype(np.int64) ** 2).sum(-1))


def test_quantize_pair_norms_and_masked_nb():
    """Norms as kernel 2b reads them: |q|^2 of the int8 rows for the
    queries, and for the database the same with INT8_NB_MASKED on masked
    rows; batched (B, N, 128) inputs keep their leading axes."""
    rng = np.random.default_rng(9)
    d1, d2 = nonneg_unit(rng, 2, 70), nonneg_unit(rng, 2, 90)
    mask2 = rng.uniform(size=(2, 90)) > 0.3
    q8, nq, db8, nb = tm.quantize_pair_int8(torch.tensor(d1),
                                            torch.tensor(d2),
                                            torch.tensor(mask2))
    assert q8.shape == (2, 70, 128) and nq.shape == (2, 70)
    assert db8.shape == (2, 90, 128) and nb.shape == (2, 90)
    b = np.clip(np.round(d2 * 256), 0, 127).astype(np.int64)
    q = np.clip(np.round(d1 * 256), 0, 127).astype(np.int64)
    np.testing.assert_array_equal(nq.numpy(), (q * q).sum(-1))
    want = np.where(mask2, (b * b).sum(-1), tm.INT8_NB_MASKED)
    np.testing.assert_array_equal(nb.numpy(), want)
    # every real norm sits below the masked marker
    assert (b * b).sum(-1).max() < tm.INT8_NB_MASKED
    # no mask: every norm is real
    _, _, _, nb_all = tm.quantize_pair_int8(torch.tensor(d1),
                                            torch.tensor(d2))
    np.testing.assert_array_equal(nb_all.numpy(), (b * b).sum(-1))


def test_quantize_pair_cpu_takes_the_plain_version():
    """On CPU tensors the quantize wrapper and knn2_int8 run the plain
    versions and count no launch."""
    rng = np.random.default_rng(10)
    d1 = torch.tensor(nonneg_unit(rng, 40)).to(torch.bfloat16)
    d2 = torch.tensor(nonneg_unit(rng, 50))
    before = (tm.quantize_pair_int8.launches, tm.knn2_int8.launches)
    got = tm.quantize_pair_int8(d1, d2)
    want = (*tm.quantize_int8_reference(d1), *tm.quantize_int8_reference(d2))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tm.knn2_int8(d1, d2)
    assert (tm.quantize_pair_int8.launches, tm.knn2_int8.launches) == before


@pytest.mark.parametrize("batched", [False, True])
def test_wrapper_on_an_empty_database(batched):
    """No database row gives no match for every query, d1 = d2 = +inf and
    idx 0, the result knn2_int8_kernel returns on the card for N2 = 0."""
    rng = np.random.default_rng(13)
    d1 = torch.tensor(nonneg_unit(rng, 2, 30) if batched
                      else nonneg_unit(rng, 30))
    d2 = torch.zeros(d1.shape[:-2] + (0, 128))
    before = tm.knn2_int8.launches
    d1_sq, d2_sq, idx = tm.knn2_int8(d1, d2)
    assert tm.knn2_int8.launches == before
    assert d1_sq.shape == d1.shape[:-1] and idx.dtype == torch.int32
    assert torch.isinf(d1_sq).all() and torch.isinf(d2_sq).all()
    assert (idx == 0).all()


def emulate_kernel_2b(q, b, mask2):
    """A numpy model of the algorithm that knn2_int8.cu folds with (it does
    not run the kernel): 128-column tiles, as the kernel's kBN; the thread
    with lane q4 of a row sees columns 8 j + 2 q4 + e; per tile an integer
    top-2 of key = 256 acc + nbk (nbk = 127 - c - 128 |b|^2, or -2^30
    masked or past N2), folded into a running (val, column) top-2; then the
    merge of the four lanes; val < -2,064,512 is no column."""
    n1, n2 = q.shape[0], b.shape[0]
    acc = q @ b.T                                           # (n1, n2)
    nb = np.where(mask2, (b * b).sum(1), tm.INT8_NB_MASKED)
    none = np.iinfo(np.int32).min
    lanes = []
    for q4 in range(4):
        best = np.full(n1, none, np.int64)
        second = np.full(n1, none, np.int64)
        idx = np.zeros(n1, np.int64)
        for n0 in range(0, n2, 128):
            c = np.array([8 * j + 2 * q4 + e for j in range(16)
                          for e in range(2)])
            col = n0 + c
            ok = col < n2
            nbc = np.where(ok, nb[np.minimum(col, n2 - 1)], tm.INT8_NB_MASKED)
            nbk = np.where(nbc < tm.INT8_NB_MASKED, 127 - c - 128 * nbc,
                           -(1 << 30))
            a = np.where(ok, acc[:, np.minimum(col, n2 - 1)], 0)
            key = a * 256 + nbk[None, :]
            assert key.max() < 2 ** 31 and key.min() > -2 ** 31
            ks = np.sort(key, axis=1)
            kb, kt = ks[:, -1], ks[:, -2]
            vb, vs = kb >> 7, kt >> 7
            up = vb > best
            second = np.where(up, np.maximum(best, vs),
                              np.maximum(second, vb))
            idx = np.where(up, n0 + 127 - (kb & 127), idx)
            best = np.where(up, vb, best)
        lanes.append((best, second, idx))
    best, second, idx = lanes[0]
    for ob, os_, oi in lanes[1:]:
        take = (ob > best) | ((ob == best) & (oi < idx))
        second = np.where(take, np.maximum(best, os_),
                          np.maximum(second, ob))
        idx = np.where(take, oi, idx)
        best = np.where(take, ob, best)
    na = (q * q).sum(1)

    def dist(v):
        d = (np.maximum(na - v, 0) / 65536.0).astype(np.float32)
        return np.where(v < -2064512, np.float32(np.inf), d)
    return dist(best), dist(second), np.where(best < -2064512, 0, idx)


@pytest.mark.parametrize("case", ["ragged masked", "one column",
                                  "all masked", "masked tile", "ties"])
def test_kernel_2b_fold_equals_exact_numpy(case):
    """The packed-key fold of kernel 2b's design, modelled in numpy, equals
    the exact 2-NN (idx, d1^2, d2^2) on ragged, masked and tied inputs (the
    kernel itself is held to its plain version on the card)."""
    rng = np.random.default_rng(11)
    n1, n2 = 60, 300
    d1, d2 = nonneg_unit(rng, n1), nonneg_unit(rng, n2)
    mask2 = rng.uniform(size=n2) > 0.2
    if case == "one column":
        mask2[:] = False
        mask2[131] = True
    elif case == "all masked":
        mask2[:] = False
    elif case == "masked tile":
        mask2[128:256] = False
    elif case == "ties":
        mask2[:] = True
        d2[250] = d2[3]
        d2[129] = d2[3]
        d1[:5] = d2[3]
    want = numpy_knn2_int8(d1, d2, mask2)
    q = np.clip(np.round(d1 * 256), 0, 127).astype(np.int64)
    b = np.clip(np.round(d2 * 256), 0, 127).astype(np.int64)
    got = emulate_kernel_2b(q, b, mask2)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0].astype(np.float32))
    np.testing.assert_array_equal(got[1], want[1].astype(np.float32))
    if case == "ties":
        assert np.all(got[2][:5] == 3) and np.all(got[0][:5] == got[1][:5])
