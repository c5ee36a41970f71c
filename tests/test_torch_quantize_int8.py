"""The int8 × int8 searches of the port's `ops.quantize` and the store's
`device_refine` against the JAX package's, on the CPU.

Both sides take the same numpy inputs. The int8 product is exact on both
(XLA's int32 dot; `torch._int_mm`), the scores are formed in the same order
and rounded to bf16 alike, and the selection is exact on both, so the
candidates' scores are the same bits and the ids are equal on these
inputs. The exact re-score sums its f32 products in another order (XLA's
dot against torch's einsum): on these unit-norm rows the scores differ by
at most 6e-8 (measured), and the test holds them within 1e-6, absolute and
relative.

Among equal scores the port takes the lowest row first (`_stable_topk`, a
stable descending sort). JAX's `lax.top_k` does too on the CPU, and so does
`lax.approx_max_k` of f32 scores with k < N (XLA's TopK), but
`approx_max_k` of the bf16 sweep scores lowers to XLA's unstable sort: its
values are exactly sorted and its order among equal values is the sort's
own (ROADMAP C-2, corrected in this slice). Where such ties are planted,
the port is held to a numpy stable sort, and JAX to the same values and to
the same ids up to the order among equal scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.index import DeviceIndex as JDeviceIndex
from rag_dpo_tpu.index import IndexConfig as JIndexConfig
from rag_dpo_tpu.ops import quantize as jq
from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.ops import quantize as tq

SCORE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(n, d, seed, nq=8):
    rng = np.random.default_rng(seed)
    return _unit(rng, (nq, d)), _unit(rng, (n, d))


def _both(e):
    """The int8 image on both sides (bit for bit equal, as
    test_torch_pooled holds)."""
    je8, jes = jq.quantize_rows(jnp.asarray(e))
    te8, tes = tq.quantize_rows(torch.from_numpy(e))
    np.testing.assert_array_equal(te8.numpy(), np.asarray(je8))
    return (je8, jes), (te8, tes)


def assert_same(port, ref):
    (ts, ti), (js, ji) = port, ref
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)


def test_selfrefined_matches_jax_and_the_dequant_oracle():
    q, e = _corpus(3000, 128, seed=5)
    (je8, jes), (te8, tes) = _both(e)
    got = tq.approx_topk_int8_selfrefined(torch.from_numpy(q), te8, tes,
                                          k=10, oversample=8)
    assert_same(got, jq.approx_topk_int8_selfrefined(
        jnp.asarray(q), je8, jes, k=10, oversample=8))
    # the reference test's oracle (tests/test_quantize.py:62): exact top-k
    # under the dequantized rows
    deq = te8.numpy().astype(np.float32) * tes.numpy()[:, None]
    s_ref = q @ deq.T
    i_ref = np.argsort(-s_ref, axis=1)[:, :10]
    ids = got[1].numpy()
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(ids, i_ref)]) >= 0.95
    np.testing.assert_allclose(got[0].numpy(),
                               np.take_along_axis(s_ref, ids, 1), atol=1e-5)
    # penalties: −1e4 holes and −1e30 rows
    pen = np.where(np.arange(3000) % 3 == 0, -1e30,
                   np.where(np.arange(3000) % 5 == 0, -1e4, 0.0))
    pen = pen.astype(np.float32)
    got = tq.approx_topk_int8_selfrefined(torch.from_numpy(q), te8, tes,
                                          k=10, oversample=8,
                                          penalty=torch.from_numpy(pen))
    assert_same(got, jq.approx_topk_int8_selfrefined(
        jnp.asarray(q), je8, jes, k=10, oversample=8,
        penalty=jnp.asarray(pen)))
    ids = got[1].numpy()
    assert ((ids[ids >= 0] % 3 != 0) & (ids[ids >= 0] % 5 != 0)).all()


def test_blockscan_matches_jax_and_selfrefined():
    """2,900 rows in 512-row blocks: the last block is start-clamped and
    its rows scored by the block before are masked (tests/test_quantize.py
    :144)."""
    q, e = _corpus(2900, 128, seed=11)
    (je8, jes), (te8, tes) = _both(e)
    tqf, jqf = torch.from_numpy(q), jnp.asarray(q)
    got = tq.approx_topk_int8_blockscan(tqf, te8, tes, k=10, oversample=8,
                                        block_rows=512)
    assert_same(got, jq.approx_topk_int8_blockscan(
        jqf, je8, jes, k=10, oversample=8, block_rows=512))
    for row in got[1].numpy():
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid), "duplicate id"
    full = tq.approx_topk_int8_selfrefined(tqf, te8, tes, k=10, oversample=8)
    np.testing.assert_allclose(got[0].numpy(), full[0].numpy(), atol=1e-6)


def assert_ids_equal_up_to_tie_order(vals, ids, ref_ids):
    """Each row's `vals` are sorted descending; within a run of equal values
    the two id lists hold the same ids, but in the run that the cut ends
    (which of the tied rows made it is the selection's choice)."""
    for v, a, b in zip(vals, ids, ref_ids):
        starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
        for lo, hi in zip(starts, np.r_[starts[1:], len(v)]):
            if hi < len(v):
                assert sorted(a[lo:hi]) == sorted(b[lo:hi])


def _sweep_bf16(q, e8, es, pen=None):
    """The port's bf16 sweep scores as numpy f32 (the same bits as JAX's:
    the candidates' values are compared bit for bit below)."""
    scores = tq._sweep(*tq.quantize_rows(torch.from_numpy(q)), e8, es,
                       None if pen is None else torch.from_numpy(pen))
    return scores.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("pen_kind", [None, "holes"])
def test_blockscan_candidates_match_jax_up_to_tie_order(pen_kind):
    """The scanned candidates themselves (bf16 scores widened to f32, row
    ids): the same bits as JAX's, and the same ids up to the order among
    equal scores; the port's are the head of a stable descending sort of
    the whole sweep, the blocks merged in row order."""
    q, e = _corpus(700, 64, seed=12)
    (je8, jes), (te8, tes) = _both(e)
    pen = (None if pen_kind is None else
           np.where(np.arange(700) % 2 == 0, -1e4, 0.0).astype(np.float32))
    jqi, jqs = jq.quantize_rows(jnp.asarray(q))
    tqi, tqs = tq.quantize_rows(torch.from_numpy(q))
    full = _sweep_bf16(q, te8, tes, pen)
    for kk, block_rows in ((40, 256), (700, 256), (40, 1000)):
        cv, ci = tq.int8_blockscan_candidates(
            tqi, tqs, te8, tes, kk, block_rows,
            penalty=None if pen is None else torch.from_numpy(pen))
        jv, ji = jq.int8_blockscan_candidates(
            jqi, jqs, je8, jes, kk, block_rows,
            penalty=None if pen is None else jnp.asarray(pen))
        cv, ci, jv, ji = cv.numpy(), ci.numpy(), np.asarray(jv), np.asarray(ji)
        np.testing.assert_array_equal(cv.view(np.int32), jv.view(np.int32))
        stable = np.argsort(-full, axis=1, kind="stable")[:, :kk]
        np.testing.assert_array_equal(ci, stable)
        np.testing.assert_array_equal(np.take_along_axis(full, ji, 1), jv)
        assert_ids_equal_up_to_tie_order(cv, ci, ji)


def test_blockscan_penalty_and_edges_match_jax():
    """tests/test_quantize.py:168's cases: −1e4 holes on every other row,
    kk > N (4 rows, k 10: padded), a single block (block_rows ≥ N)."""
    q, e = _corpus(700, 64, seed=12)
    (je8, jes), (te8, tes) = _both(e)
    tqf, jqf = torch.from_numpy(q), jnp.asarray(q)
    pen = np.where(np.arange(700) % 2 == 0, -1e4, 0.0).astype(np.float32)
    got = tq.approx_topk_int8_blockscan(tqf, te8, tes, k=10, oversample=8,
                                        block_rows=256,
                                        penalty=torch.from_numpy(pen))
    assert_same(got, jq.approx_topk_int8_blockscan(
        jqf, je8, jes, k=10, oversample=8, block_rows=256,
        penalty=jnp.asarray(pen)))
    ids = got[1].numpy()
    assert (ids[ids >= 0] % 2 != 0).all()
    got = tq.approx_topk_int8_blockscan(tqf[:2], te8[:4], tes[:4], k=10,
                                        block_rows=256)
    assert_same(got, jq.approx_topk_int8_blockscan(
        jqf[:2], je8[:4], jes[:4], k=10, block_rows=256))
    assert (got[1][:, 4:] == -1).all() and (got[0][:, 4:] == -1e30).all()
    got = tq.approx_topk_int8_blockscan(tqf, te8, tes, k=5, block_rows=4096)
    assert_same(got, jq.approx_topk_int8_blockscan(jqf, je8, jes, k=5,
                                                   block_rows=4096))


def test_blockscan_with_e_ref_matches_jax_and_refined():
    """tests/test_quantize.py:228: the re-score against a full-precision
    row store, scanned and in one sweep."""
    q, e = _corpus(1500, 128, seed=13)
    (je8, jes), (te8, tes) = _both(e)
    tqf, jqf = torch.from_numpy(q), jnp.asarray(q)
    t_ref, j_ref = torch.from_numpy(e), jnp.asarray(e)
    got = tq.approx_topk_int8_blockscan(tqf, te8, tes, k=10, oversample=8,
                                        block_rows=400, e_ref=t_ref)
    assert_same(got, jq.approx_topk_int8_blockscan(
        jqf, je8, jes, k=10, oversample=8, block_rows=400, e_ref=j_ref))
    refined = tq.approx_topk_int8_refined(tqf, te8, tes, t_ref, k=10,
                                          oversample=8)
    assert_same(refined, jq.approx_topk_int8_refined(
        jqf, je8, jes, j_ref, k=10, oversample=8))
    np.testing.assert_allclose(got[0].numpy(), refined[0].numpy(),
                               atol=1e-6)
    # kk < k: the refined search pads, keeping its ids as the reference
    # does (no −1 for empty slots there)
    got = tq.approx_topk_int8_refined(tqf[:2], te8[:6], tes[:6], t_ref[:6],
                                      k=8, oversample=1)
    assert_same(got, jq.approx_topk_int8_refined(
        jqf[:2], je8[:6], jes[:6], j_ref[:6], k=8, oversample=1))


@pytest.mark.parametrize("oversample", [1, 4])
def test_approx_topk_int8_matches_jax(oversample):
    q, e = _corpus(2000, 128, seed=0)
    (je8, jes), (te8, tes) = _both(e)
    jqi, jqs = jq.quantize_rows(jnp.asarray(q))
    tqi, tqs = tq.quantize_rows(torch.from_numpy(q))
    pen = np.where(np.arange(2000) % 7 == 0, -1e4, 0.0).astype(np.float32)
    for p in (None, pen):
        got = tq.approx_topk_int8(
            tqi, tqs, te8, tes, k=10, oversample=oversample,
            penalty=None if p is None else torch.from_numpy(p))
        want = jq.approx_topk_int8(
            jqi, jqs, je8, jes, k=10, oversample=oversample,
            penalty=None if p is None else jnp.asarray(p))
        # no refine: the f32 sweep scores themselves, the same bits
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    got = tq.approx_topk_int8(tqi, tqs, te8[:3], tes[:3], k=5,
                              oversample=oversample)
    want = jq.approx_topk_int8(jqi, jqs, je8[:3], jes[:3], k=5,
                               oversample=oversample)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_dequant_refine_matches_jax():
    q, e = _corpus(500, 64, seed=3)
    (je8, jes), (te8, tes) = _both(e)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 500, (8, 30)).astype(np.int32)
    ids[:, ::7] = -1
    scores = rng.standard_normal((8, 30)).astype(np.float32)
    scores[:, 3] = -1e4                                # penalized slots
    for k in (10, 40):                                 # 40 > 30: padded
        got = tq.dequant_refine(torch.from_numpy(q), te8, tes,
                                torch.from_numpy(scores),
                                torch.from_numpy(ids), k)
        assert_same(got, jq.dequant_refine(jnp.asarray(q), je8, jes,
                                           jnp.asarray(scores),
                                           jnp.asarray(ids), k))


def _planted(noise):
    """Copies of 25 unit vectors, 16 of each at scattered rows (noise 0:
    exact copies; 2e-3: near-copies whose bf16 scores mostly tie while
    their exact scores differ), and 4 queries near the first four."""
    rng = np.random.default_rng(21)
    base = _unit(rng, (25, 96))
    rows = np.repeat(base, 16, axis=0)
    rows = rows + noise * rng.standard_normal(rows.shape).astype(np.float32)
    rows = rows[rng.permutation(len(rows))].astype(np.float32)
    q = (base[:4] + 0.3 * base[4:8])
    return q / np.linalg.norm(q, axis=1, keepdims=True), rows


@pytest.mark.parametrize("noise", [0.0, 2e-3])
def test_planted_bf16_ties_across_the_cut(noise):
    """k 10 × oversample 4 cuts the sweep's top-40 inside a run of equal
    bf16 scores. The port keeps the lowest rows of the run, and its
    candidates are a stable descending sort's head; the refined results
    equal JAX's in scores, and in ids but where JAX took another of
    several exactly equal rows (noise 0: copies whose int8 rows are the
    same bytes; with noise, the ids are equal)."""
    q, rows = _planted(noise)
    (je8, jes), (te8, tes) = _both(rows)
    sweep = _sweep_bf16(q, te8, tes)
    top = -np.sort(-sweep, axis=1)
    assert (top[:, 39] == top[:, 40]).any()               # a tie at the cut
    stable = np.argsort(-sweep, axis=1, kind="stable")[:, :40]
    cv, ci = tq._stable_topk(torch.from_numpy(sweep), 40)
    np.testing.assert_array_equal(ci.numpy(), stable)
    tqf, jqf = torch.from_numpy(q), jnp.asarray(q)
    for got, want in (
            (tq.approx_topk_int8_selfrefined(tqf, te8, tes, k=10),
             jq.approx_topk_int8_selfrefined(jqf, je8, jes, k=10)),
            (tq.approx_topk_int8_blockscan(tqf, te8, tes, k=10,
                                           block_rows=96),
             jq.approx_topk_int8_blockscan(jqf, je8, jes, k=10,
                                           block_rows=96))):
        (ts, ti), (js, ji) = got, want
        ti, ji = ti.numpy(), np.asarray(ji)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)
        if noise:
            np.testing.assert_array_equal(ti, ji)
        else:
            np.testing.assert_array_equal(te8.numpy()[ti], np.asarray(je8)[ji])


def _store_pair(n, dim, seed, **cfg):
    rng = np.random.default_rng(seed)
    e = _unit(rng, (n, dim))
    metas = [{"nature": "GUIDE" if i % 2 else "DOCTRINE"} for i in range(n)]
    ids = [f"c{i}" for i in range(n)]
    jidx = JDeviceIndex(JIndexConfig(dim=dim, ell_width=4, row_block=64,
                                     quantize_int8=True, device_refine=True,
                                     **cfg))
    idx = DeviceIndex(IndexConfig(dim=dim, ell_width=4, row_block=64,
                                  quantize_int8=True, device_refine=True,
                                  **cfg), device="cpu")
    for index in (jidx, idx):
        index.add(ids, e, metas)
    return jidx, idx, e


@pytest.mark.parametrize("sweep_block_rows", [0, 128])
@pytest.mark.parametrize("where", [None, {"nature": "DOCTRINE"}])
def test_store_device_refine_matches_jax(sweep_block_rows, where):
    """`IndexConfig(quantize_int8=True, device_refine=True)` on both sides:
    one sweep (0) or forced 128-row blocks (tests/test_quantize.py:192's
    routing case), with and without a filter, then after a delete."""
    jidx, idx, e = _store_pair(400, 64, seed=9,
                               sweep_block_rows=sweep_block_rows)
    rng = np.random.default_rng(1)
    queries = np.concatenate([e[[7, 123, 350]], _unit(rng, (5, 64))])
    before = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    for step in range(2):
        ts, ti = idx.search_dense(queries, 5, where=where)
        js, ji = jidx.search_dense(queries, 5, where=where)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, **SCORE_TOL)
        if where is None and step == 0:
            assert ti[:3, 0].tolist() == [7, 123, 350]
        if where is not None:
            assert all(idx.meta.row(int(r))["nature"] == "DOCTRINE"
                       for r in ti.ravel() if r >= 0)
        for index in (idx, jidx):
            index.delete(["c123", "c350"])
    assert 123 not in ti and 350 not in ti
    assert (dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)) == before


def test_store_device_refine_past_the_rows_and_round_trip(tmp_path):
    """k past the live rows pads (−1e30, −1) as JAX does; the config
    round-trips through the checkpoint across the packages."""
    jidx, idx, e = _store_pair(40, 64, seed=2, sweep_block_rows=32)
    ts, ti = idx.search_dense(e[:3], 100)
    js, ji = jidx.search_dense(e[:3], 100)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **SCORE_TOL)
    assert (ti[:, 40:] == -1).all() and (ts[:, 40:] == -1e30).all()
    idx.save(tmp_path / "port")
    back = JDeviceIndex.load(tmp_path / "port")
    assert back.config.device_refine and back.config.sweep_block_rows == 32
    np.testing.assert_array_equal(back.search_dense(e[:3], 10)[1], ti[:, :10])
    jidx.save(tmp_path / "jax")
    again = DeviceIndex.load(tmp_path / "jax", device="cpu")
    assert again.config.device_refine
    np.testing.assert_array_equal(again.search_dense(e[:3], 10)[1],
                                  ti[:, :10])
