"""The fixed-order segment sum (ops/segsum) and the sums that go through it.

On the CPU `segment_sum` is its plain version (a `segment_reduce` over the
plan's sorted slots, one slot after another in the values' dtype); the
CUDA kernel (ops/csrc/segsum.cu) runs only on the card
(`test_kernel_on_the_card`, and `chip_smoke.py` phase 14).  The plan's
block metadata (merge-path blocks of `chunk` items, the cross-block bins'
partials and tickets) is checked here on a model of the kernel's order:
per block, each bin's slots summed in f64, a cross-block bin's partials
added in block order by the block that takes its last ticket.  The plain
version is held to an f64 `index_add_` of the same slots within 1e-12 of
each bin's sum of |values| in f64, and bit for bit to the CPU's f32
`index_add_` (the order the port summed in before, and the order of XLA's
CPU scatter-add in the JAX package).  A source scan keeps every remaining
scatter-add of the port on a list of sums that are exact in any order: a
new atomic float sum fails it.
"""
import ast
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from metricsfm_tpu_torch.ops import segsum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "metricsfm_tpu_torch")


def _index_add(values, bins, n_bins, mask=None):
    """The yardstick: an index_add_ of the kept rows in values' dtype."""
    v = values.reshape(bins.numel(), int(np.prod(values.shape[bins.dim():])))
    b = bins.reshape(-1)
    if mask is not None:
        keep = mask.reshape(-1)
        v, b = v[keep], b[keep]
    out = torch.zeros((n_bins, v.shape[1]), dtype=values.dtype)
    return out.index_add_(0, b, v)


def _check_sum(values, bins, n_bins, mask=None):
    """f32 values: bit-equal to the f32 index_add_; the same values in f64:
    within 1e-12 of each bin's sum of |values| of the f64 index_add_."""
    plan = segsum.make_plan(bins, n_bins, mask)
    got = segsum.segment_sum(values, plan).reshape(n_bins,
                                                    values.shape[-1])
    assert got.dtype == values.dtype
    torch.testing.assert_close(got, _index_add(values, bins, n_bins, mask),
                               rtol=0, atol=0)
    v64 = values.double()
    got64 = segsum.segment_sum(v64, plan).reshape(n_bins, values.shape[-1])
    want64 = _index_add(v64, bins, n_bins, mask)
    absmass = _index_add(v64.abs(), bins, n_bins, mask)
    err = (got64 - want64).abs()
    assert bool((err <= 1e-12 * absmass + 1e-300).all()), float(err.max())
    return got, want64


def _skewed_bins(rng, n_bins, n):
    """Bins of n slots: most in one bin, some in a few others, many bins
    empty."""
    if n_bins == 1:
        return np.zeros(n, np.int64)
    heavy = rng.integers(0, n_bins)
    b = rng.integers(0, n_bins, n)
    b[rng.uniform(size=n) < 0.7] = heavy
    return b


@pytest.mark.parametrize("K", [1, 3, 6, 9, 18, 27, 36, 81, 128])
def test_plain_sum_matches_index_add_at_call_site_widths(K):
    """The widths the port's call sites use, on skewed bins with empty
    ones, a tail of several dims and a masked share of the slots."""
    rng = np.random.default_rng(K)
    n_bins, n = 37, 900
    bins = torch.from_numpy(_skewed_bins(rng, n_bins, n)).reshape(30, 30)
    values = torch.from_numpy(
        rng.normal(size=(30, 30, K)).astype(np.float32) * 10.0)
    mask = torch.from_numpy(rng.uniform(size=(30, 30)) < 0.8)
    _check_sum(values, bins, n_bins)
    got, _ = _check_sum(values, bins, n_bins, mask)
    empty = np.setdiff1d(np.arange(n_bins), bins.numpy()[mask.numpy()])
    assert (got[torch.from_numpy(empty)] == 0).all()


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.one_of(st.just(0), st.just(1),
                                  st.integers(0, 40),
                                  st.integers(200, 3000)),
                        min_size=1, max_size=24),
       K=st.integers(1, 128), seed=st.integers(0, 2 ** 31 - 1))
def test_plain_sum_matches_index_add(lengths, K, seed):
    """Any bin lengths (empty, single, skewed), any width from 1 to 128,
    slots in a shuffled order, values over six orders of magnitude."""
    rng = np.random.default_rng(seed)
    bins = np.repeat(np.arange(len(lengths)), lengths)
    rng.shuffle(bins)
    values = rng.normal(size=(len(bins), K)).astype(np.float32) \
        * rng.choice([1e-3, 1.0, 1e3])
    _check_sum(torch.from_numpy(values), torch.from_numpy(bins),
               len(lengths))


def test_plan_is_a_stable_sort_with_offsets():
    """perm holds the kept slots sorted by bin, in slot order within a bin,
    then the dropped slots in slot order; off[s + 1] - off[s] counts bin s."""
    rng = np.random.default_rng(0)
    n_bins, n = 11, 500
    bins = rng.integers(0, n_bins, n)
    bins[::7] = 4                        # one heavy bin
    bins[bins == 9] = 3                  # one empty bin
    keep = rng.uniform(size=n) < 0.75
    plan = segsum.make_plan(torch.from_numpy(bins), n_bins,
                            torch.from_numpy(keep))
    perm, off = plan.perm.numpy(), plan.off.numpy()
    assert plan.perm.dtype == torch.int32 and plan.off.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(n))
    kept = np.nonzero(keep)[0]
    want = kept[np.argsort(bins[kept], kind="stable")]
    np.testing.assert_array_equal(perm[:len(kept)], want)
    np.testing.assert_array_equal(perm[len(kept):], np.nonzero(~keep)[0])
    np.testing.assert_array_equal(
        np.diff(off), np.bincount(bins[kept], minlength=n_bins))
    assert off[0] == 0 and off[-1] == len(kept) and off[9 + 1] == off[9]
    assert plan.n_slots == n and plan.n_bins == n_bins


def test_empty_plans():
    """No slots, no bins, and every slot dropped."""
    none = segsum.make_plan(torch.zeros(0, dtype=torch.int64), 5)
    assert (segsum.segment_sum(torch.ones(0, 3), none) == 0).all()
    assert segsum.segment_sum(torch.ones(0, 3), none).shape == (5, 3)
    nobins = segsum.make_plan(torch.zeros(0, dtype=torch.int64), 0)
    assert segsum.segment_sum(torch.ones(0, 2), nobins).shape == (0, 2)
    dropped = segsum.make_plan(torch.tensor([1, 7]), 3,
                               torch.tensor([False, False]))
    assert (segsum.segment_sum(torch.ones(2, 4), dropped) == 0).all()


def test_strided_values_are_read_in_place():
    """A column slice of a wider tensor (BA's U[:, :, :6]) sums as its
    copy does."""
    rng = np.random.default_rng(1)
    U = torch.from_numpy(rng.normal(size=(40, 5, 9, 3)).astype(np.float32))
    bins = torch.from_numpy(rng.integers(0, 6, (40, 5)))
    plan = segsum.make_plan(bins, 6)
    for part in (U[:, :, :6], U[:, :, 6:]):
        torch.testing.assert_close(segsum.segment_sum(part, plan),
                                   segsum.segment_sum(part.contiguous(), plan),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("bins, mask", [
    (torch.tensor([0, 3, 1]), None),
    (torch.tensor([0, -1, 1]), None),
    (torch.tensor([[0, 2], [5, 1]]), torch.tensor([[True, True],
                                                   [True, False]])),
])
def test_out_of_range_bin_raises(bins, mask):
    with pytest.raises(IndexError, match="outside"):
        segsum.make_plan(bins, 3, mask)


def test_masked_bins_are_not_checked():
    """A dropped slot may carry any bin (padding)."""
    plan = segsum.make_plan(torch.tensor([0, 99, -5, 2]), 3,
                            torch.tensor([True, False, False, True]))
    out = segsum.segment_sum(torch.tensor([1.0, 5.0, 7.0, 2.0]), plan)
    np.testing.assert_array_equal(out.numpy(), [1.0, 0.0, 2.0])


def test_values_must_lead_with_the_plan_shape():
    plan = segsum.make_plan(torch.zeros((4, 3), dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="slot shape"):
        segsum.segment_sum(torch.ones(3, 4), plan)


def test_ba_plans_cover_the_problem():
    """solve_lm's plans: the slots by camera and model with masked slots
    dropped; the dense path adds the (point, camera) plans, the PCG path
    does not; triples only with priors, zero-weight triples dropped."""
    from metricsfm_tpu_torch.ba.lm import LMConfig, make_plans
    from metricsfm_tpu_torch.utils import synth

    prob = synth.synthetic_ba_problem(6, 64, device="cpu")
    prob = prob._replace(
        gps_triple=torch.tensor([[0, 1, 2], [1, 2, 3], [0, 0, 0]]),
        gps_triple_weight=torch.tensor([[1.0, 1.0], [0.5, 0.0], [0.0, 0.0]]))
    n_obs = int(prob.track_mask.sum())
    dense = make_plans(prob, LMConfig(), priors=True)
    pcg = make_plans(prob, LMConfig(cg_iterations=10), priors=False)
    assert int(dense.cam.off[-1]) == int(dense.model.off[-1]) == n_obs
    np.testing.assert_array_equal(
        torch.diff(dense.cam.off).numpy(),
        np.bincount(prob.track_cam[prob.track_mask].numpy(), minlength=6))
    assert dense.point_cam.n_bins == prob.n_points * 6
    assert pcg.point_cam is None and pcg.triple is None and pcg.pair is None
    assert int(dense.triple.off[-1]) == 6 and int(dense.pair.off[-1]) == 18



# -- the kernel's blocks, modelled on the CPU ---------------------------------

def _blocks(plan):
    """The kernel's blocks as it reads them from the plan: (first slot i0,
    slots n, first bin s0, bins ending in the block nb) for block b of
    ceil((kept + n_bins) / chunk)."""
    C, cb = plan.chunk, plan.chunk_bin.tolist()
    nblk = -(-(plan.kept + plan.n_bins) // C)
    out = []
    for b in range(nblk):
        s0, i0 = cb[b], b * C - cb[b]
        if b + 1 < nblk:
            s1, i1 = cb[b + 1], (b + 1) * C - cb[b + 1]
        else:
            s1, i1 = plan.n_bins, plan.kept
        out.append((i0, i1 - i0, s0, s1 - s0))
    return out


def _kernel_model(values64, plan):
    """The kernel's order, block by block (ops/csrc/segsum.cu): a bin's
    slots in a block summed in f64 in slot order; a bin that ends in the
    block with all its slots there is written by it; a bin over several
    blocks leaves a partial in each (`tail` from its first block, `head`
    from the others) and is written by whichever takes its last ticket,
    which adds them in block order.  Returns (out, writes: bin -> writers,
    cross: bin -> [(block, "tail" | "head")] in arrival order by block,
    keys: bin -> (first block, ticket block))."""
    off = plan.off.tolist()
    C, S = plan.chunk, plan.n_bins
    v = values64.reshape(plan.n_slots, values64.shape[-1])[
        plan.perm[:plan.kept].long()]
    K = v.shape[1]
    out = torch.full((S, K), float("nan"), dtype=torch.float64)
    writes = {s: [] for s in range(S)}
    cross, keys, parts = {}, {}, {}

    def part(a, z):
        return v[a:z].sum(0) if z > a else torch.zeros(K, dtype=torch.float64)

    for b, (i0, n, s0, nb) in enumerate(_blocks(plan)):
        open_front = off[s0] < i0
        for j in range(nb):
            s = s0 + j
            a, z = max(off[s], i0), off[s + 1]
            if j == 0 and open_front:
                parts[(s, b)] = part(a, z)
                cross.setdefault(s, []).append((b, "head"))
                keys[s] = ((off[s] + s) // C, b)
            else:
                out[s] = part(a, z)
                writes[s].append(b)
        s1 = s0 + nb
        lo_nb = 0 if nb == 0 else off[s1] - i0
        if s1 < S and lo_nb < n:
            kind = "head" if nb == 0 and open_front else "tail"
            parts[(s1, b)] = part(max(off[s1], i0), i0 + n)
            cross.setdefault(s1, []).append((b, kind))
            keys[s1] = ((off[s1] + s1) // C, (off[s1 + 1] + s1) // C)
    for s, blocks in cross.items():
        first, last = keys[s]
        total = torch.zeros(K, dtype=torch.float64)
        for b in range(first, last + 1):
            total = total + parts[(s, b)]
        out[s] = total
        writes[s].append(("combine", last))
    return out, writes, cross, keys


def _check_model(plan, values):
    """The metadata's invariants and the model's sums (within 1e-12 of each
    bin's sum of |values| of the f64 index_add_)."""
    C, S = plan.chunk, plan.n_bins
    off = plan.off.numpy().astype(np.int64)
    assert plan.kept == int(off[-1]) if S else plan.kept == 0
    blocks = _blocks(plan)
    # the table is the merged sequence's searchsorted, by hand
    ends = off[1:] + np.arange(S)
    for b in range(len(blocks) + 1):
        assert plan.chunk_bin[b] == int((ends < b * C).sum())
    assert plan.tickets.numel() >= len(blocks)
    assert (plan.tickets == 0).all()
    # every kept slot in exactly one block, each block at most C items
    covered = np.zeros(plan.kept, np.int64)
    for i0, n, s0, nb in blocks:
        assert n >= 0 and nb >= 0 and 0 < n + nb <= C
        covered[i0:i0 + n] += 1
    assert (covered == 1).all()
    v64 = values.double()
    out, writes, cross, keys = _kernel_model(v64, plan)
    # every bin written exactly once: by its block, or by one combine
    assert all(len(w) == 1 for w in writes.values()), writes
    # a cross-block bin: a tail from its first block, then a head from
    # each later block up to its ticket's, in block order
    for s, got in cross.items():
        first, last = keys[s]
        assert last > first
        assert got == [(first, "tail")] + [(b, "head") for b in
                                           range(first + 1, last + 1)]
    kept = v64.reshape(plan.n_slots, v64.shape[-1])[
        plan.perm[:plan.kept].long()]
    bins = torch.repeat_interleave(torch.arange(S),
                                   torch.diff(plan.off).long())
    want = torch.zeros_like(out).index_add_(0, bins, kept)
    mass = torch.zeros_like(out).index_add_(0, bins, kept.abs())
    assert bool(((out - want).abs() <= 1e-12 * mass + 1e-300).all())
    return out, cross


def _lengths_plan(lengths, K, seed, chunk, masked=0.0):
    rng = np.random.default_rng(seed)
    bins = np.repeat(np.arange(len(lengths)), lengths)
    rng.shuffle(bins)
    keep = torch.from_numpy(rng.uniform(size=len(bins)) >= masked)
    values = torch.from_numpy(rng.normal(size=(len(bins), K))
                              .astype(np.float32))
    plan = segsum.make_plan(torch.from_numpy(bins), len(lengths),
                            keep if masked else None, chunk=chunk)
    return plan, values


@pytest.mark.parametrize("case, lengths, chunk, masked", [
    # one bin over many blocks
    ("one long bin", [5000], 64, 0.0),
    # ends exactly on block edges: with chunk 16, bin s ends at item
    # off[s + 1] + s, so lengths of 15 put every end at an edge's last item
    ("ends on block edges", [15] * 12, 16, 0.0),
    ("empty at the start, an edge and the end",
     [0, 0, 14, 0, 17, 0, 0, 40, 0, 0], 16, 0.0),
    ("long and short mixed", [300, 1, 0, 2, 700, 0, 3, 64, 64, 0, 1], 32,
     0.0),
    ("masked slots", [90, 0, 33, 5, 0, 260], 32, 0.4),
    ("every slot masked", [30, 40], 16, 1.0),
    ("many empty bins", [0] * 500 + [7] + [0] * 300, 64, 0.0),
    ("single slot", [1], 16, 0.0),
    ("default chunk, skewed", [60000, 3, 0, 2000, 1, 0, 0, 50000], None,
     0.0),
])
def test_plan_blocks_and_the_kernel_order(case, lengths, chunk, masked):
    """The merge-path metadata of make_plan: every kept slot in one block,
    every bin written once (by its block, or by the combine of a
    cross-block bin whose partials come from consecutive blocks in order),
    and the model's sums within 1e-12 of the f64 index_add_."""
    plan, values = _lengths_plan(lengths, 3, len(case),
                                 chunk or segsum.CHUNK, masked)
    out, cross = _check_model(plan, values)
    if case == "one long bin":
        assert len(cross[0]) == -(-5001 // 64)
    if case == "every slot masked":
        assert plan.kept == 0 and (out == 0).all()


def test_plan_with_no_kept_slots_zero_fills():
    """kept == 0: the blocks hold bin ends only, every bin reads 0."""
    for n_bins in (1, 5, 16, 17, 100):
        plan = segsum.make_plan(torch.zeros(0, dtype=torch.int64), n_bins,
                                chunk=16)
        assert plan.kept == 0
        assert len(_blocks(plan)) == -(-n_bins // 16)
        out, cross = _check_model(plan, torch.zeros(0, 4))
        assert not cross and (out == 0).all()


def test_plan_serves_two_widths():
    """One plan, two widths (BA's plans.cam at K 6 and 9; a column slice
    read in place): the metadata does not depend on K, the model sums both
    widths within 1e-12, and the plain sums equal the slices' copies."""
    plan, values = _lengths_plan([400, 0, 37, 129, 0, 1], 15, 3, 32)
    assert plan.chunk_bin.numel() == -(-(plan.n_slots + 6) // 32) + 1
    for part in (values[:, :6], values[:, 6:]):
        _check_model(plan, part.contiguous())
        torch.testing.assert_close(
            segsum.segment_sum(part, plan),
            segsum.segment_sum(part.contiguous(), plan), rtol=0, atol=0)


@settings(max_examples=40, deadline=None)
@given(lengths=st.lists(st.one_of(st.just(0), st.just(1),
                                  st.integers(0, 40),
                                  st.integers(200, 3000)),
                        min_size=1, max_size=24),
       K=st.integers(1, 20), seed=st.integers(0, 2 ** 31 - 1),
       chunk=st.sampled_from([16, 64, 1024]))
def test_kernel_order_model_matches_index_add(lengths, K, seed, chunk):
    """The kernel's order (block partials in f64, cross-block partials in
    block order) within 1e-12 of the f64 index_add_ on any bin lengths."""
    plan, values = _lengths_plan(lengths, K, seed, chunk)
    _check_model(plan, values)

# -- the atomic scatters that remain ------------------------------------------

SCATTERS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
            "index_put_", "index_put", "put_", "index_reduce_",
            "index_reduce", "scatter_reduce_", "scatter_reduce", "bincount"}

# (module, enclosing function, op): why the sum is exact in any order.
ALLOWED = {
    ("ops/kmeans.py", "train_vocabulary", "index_add_"):
        "int64 row counts per coarse cell: integer adds",
    ("ops/kmeans.py", "transform", "index_add_"):
        "0/1 word counts in f32, exact below 2^24",
    ("ops/kmeans.py", "similarity_chunked", "index_add_"):
        "0/1 document frequencies in f32, exact below 2^24",
    ("ba/lm.py", "solve_reduced", "index_put"):
        "one GPS / pose-prior block per camera: unique indices",
}


def _scatter_calls():
    """(module, function, op, line) of every scatter-add in the port: the
    ops above, index_put / put_ only with accumulate=True, bincount only
    of torch (numpy's runs on the host, in order)."""
    found = []
    for root, _, files in os.walk(PORT):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, PORT).replace(os.sep, "/")
            with open(path) as f:
                tree = ast.parse(f.read())
            scopes = [(n, n.name) for n in ast.walk(tree)
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))]
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in SCATTERS):
                    continue
                op = node.func.attr
                if op.startswith(("index_put", "put_")) and not any(
                        k.arg == "accumulate" and not (
                            isinstance(k.value, ast.Constant)
                            and k.value.value is False)
                        for k in node.keywords):
                    continue
                recv = node.func.value
                if op == "bincount" and isinstance(recv, ast.Name) \
                        and recv.id in ("np", "numpy"):
                    continue
                fn = min((s for s in scopes
                          if s[0].lineno <= node.lineno <= s[0].end_lineno),
                         key=lambda s: s[0].end_lineno - s[0].lineno,
                         default=(None, "<module>"))[1]
                found.append((rel, fn, op, node.lineno))
    return found


def test_no_atomic_float_sum_outside_the_allowed_list():
    """Every remaining scatter-add of the port adds integers, 0/1 counts
    or writes unique indices; a float sum by atomics fails here."""
    calls = _scatter_calls()
    unknown = [c for c in calls if c[:3] not in ALLOWED]
    assert not unknown, ("scatter-adds not on the allowed list (sum through "
                         f"ops.segsum instead): {unknown}")
    # and the list holds nothing stale
    assert {c[:3] for c in calls} == set(ALLOWED)


def test_scan_finds_a_float_scatter(tmp_path, monkeypatch):
    """The scan sees an index_add_, a scatter_add_ and an accumulating
    index_put_, and skips a plain index_put_ and numpy's bincount."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        "import numpy as np\n"
        "def f(a, i, v):\n"
        "    a.index_add_(0, i, v)\n"
        "    a.scatter_add_(1, i, v)\n"
        "    a.index_put_((i,), v, accumulate=True)\n"
        "    a.index_put_((i,), v)\n"
        "    np.bincount(i, v)\n")
    monkeypatch.setitem(globals(), "PORT", str(pkg))
    got = {c[2] for c in _scatter_calls()}
    assert got == {"index_add_", "scatter_add_", "index_put_"}


@pytest.mark.card
def test_kernel_on_the_card():
    """The segsum kernel within 1e-6 of each bin's sum of |values| of its
    plain version run in f64 on the same values, bit-equal to itself over
    repeats (needs an NVIDIA GPU: run with `python -m pytest
    tests/test_torch_segsum.py` on the card; `chip_smoke.py` phase 14 runs
    the same checks at the main paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the segsum kernel runs only on "
                    "the card")
    rng = np.random.default_rng(2)

    def check(values, plan):
        got = [segsum.segment_sum(values, plan) for _ in range(3)]
        want = segsum.segment_sum_reference(values.double(), plan)
        mass = segsum.segment_sum_reference(values.abs().double(), plan)
        assert all(torch.equal(g, got[0]) for g in got)
        assert bool(((got[0].double() - want).abs()
                     <= 1e-6 * mass + 1e-30).all())
        assert int(plan.tickets.abs().sum()) == 0
        return got[0]

    for K in (1, 9, 36, 81, 128):
        bins = torch.from_numpy(_skewed_bins(rng, 50, 20000)).cuda()
        values = torch.from_numpy(
            rng.normal(size=(20000, K)).astype(np.float32)).cuda()
        check(values, segsum.make_plan(bins, 50))
    # one bin of 200k slots (a camera model shared by every image), the
    # plan reused: twice in a row, then after a sum of another width
    plan = segsum.make_plan(torch.zeros(200000, dtype=torch.int64,
                                        device="cuda"), 1)
    wide = torch.from_numpy(
        rng.normal(size=(200000, 12)).astype(np.float32)).cuda()
    first = check(wide[:, :3], plan)
    assert torch.equal(check(wide[:, :3], plan), first)
    check(wide[:, 3:], plan)
    assert torch.equal(check(wide[:, :3], plan), first)
