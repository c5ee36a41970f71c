"""K5 (`fused_candidates_topk`) of the port against the JAX package, on the
CPU.

The port's wrapper takes its plain twin here (a matmul, the penalty, a
stable sort of each segment, the strip, a stable sort of the strip); the
CUDA kernel is held to that twin on the card by `tests/test_torch_cuda.py`
and `chip_smoke.py`. The JAX `fused_candidates_topk` runs its Pallas
kernel in interpret mode, as the JAX package runs it on the CPU.

Unlike K4 (ROADMAP C-13), the port keeps JAX's own order among equal
scores: first lane in a segment, then the lowest strip position, also
where the strip is wider than 4,096 and JAX cuts it with `approx_max_k`
first (exact and stable on the CPU, C-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.ops.topk import fused_candidates_topk as j_fused_candidates
from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.ops.topk import (
    fused_candidates_topk,
    fused_candidates_topk_plain,
    seg_candidates_plain,
)

# scores are f32 sums of D ≤ 64 products in another order than XLA's
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run_both(queries, embs, k, pen=None, dtype=np.float32, **kw):
    """JAX's and the port's outputs on the same numpy inputs, as numpy."""
    jq, je = jnp.asarray(queries), jnp.asarray(embs)
    tq, te = torch.from_numpy(queries), torch.from_numpy(embs)
    if dtype == "bfloat16":
        jq, je = jq.astype(jnp.bfloat16), je.astype(jnp.bfloat16)
        tq, te = tq.to(torch.bfloat16), te.to(torch.bfloat16)
    jp = None if pen is None else jnp.asarray(pen)
    tp = None if pen is None else torch.from_numpy(pen)
    js, ji = j_fused_candidates(jq, je, k, penalty=jp, **kw)
    ts, ti = fused_candidates_topk(tq, te, k, penalty=tp, **kw)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert ts.shape == ti.shape == (queries.shape[0], k)
    return ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)


def _exact_scores(queries, embs, pen, dtype):
    """q·e (+ penalty, −5e29 past its end) in float64, after the inputs'
    rounding to `dtype`."""
    if dtype == "bfloat16":
        queries, embs = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16),
                                    np.float64) for x in (queries, embs))
    s = queries.astype(np.float64) @ embs.astype(np.float64).T
    if pen is not None:
        full = np.full(embs.shape[0], -5e29)
        full[:min(len(pen), len(full))] = pen[:len(full)]
        s = s + full
    return s


def assert_matches_jax(ts, ti, js, ji, queries, embs, pen=None,
                       dtype=np.float32):
    """Scores within 1e-5; ids equal but where two rows' scores lie within
    1e-5 (a near-tie the two sums may order either way): there the port's
    row must carry JAX's score of the slot."""
    np.testing.assert_allclose(ts, js, **SCORE_TOL)
    assert np.array_equal(ti >= 0, ji >= 0)
    differ = ti != ji
    if differ.any():
        exact = _exact_scores(queries, embs, pen, dtype)
        rows = np.nonzero(differ)[0]
        got = exact[rows, ti[differ]]
        np.testing.assert_allclose(got, js[differ], **SCORE_TOL)


def _gaussian(seed, q, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32), rng)


def test_hermetic_size_gives_four_candidates():
    """At the hermetic corpus (212 rows, one block of 16 segments) the top
    2 of each segment leave 4 valid rows for k = 40; 36 slots are fill."""
    queries, embs, _ = _gaussian(0, 3, 212, 16)
    ts, ti, js, ji = _run_both(queries, embs, 40)
    assert_matches_jax(ts, ti, js, ji, queries, embs)
    assert ((ti >= 0).sum(1) == 4).all()
    assert (ti[:, 4:] == -1).all() and (ts[:, 4:] == -1e30).all()


@pytest.mark.parametrize("q,n,d,k,block_n,seg,per_seg,dtype", [
    (5, 5000, 32, 40, 1024, 64, 3, np.float32),   # N % block_n != 0
    (4, 6000, 24, 40, 2048, 128, 1, np.float32),
    (3, 6000, 24, 40, 2048, 64, 2, np.float32),
    (2, 7000, 16, 30, 1024, 128, 2, np.float32),
    (6, 4100, 32, 40, 1024, 64, 1, np.float32),
    (3, 9000, 64, 50, 2048, 128, 3, np.float32),
    (4, 5000, 32, 40, 2048, 128, 2, "bfloat16"),
    (3, 3000, 16, 40, 1024, 64, 3, "bfloat16"),
])
def test_twin_matches_jax_tie_free(q, n, d, k, block_n, seg, per_seg, dtype):
    queries, embs, _ = _gaussian(q * n + seg, q, n, d)
    kw = dict(block_n=block_n, seg=seg, per_seg=per_seg)
    ts, ti, js, ji = _run_both(queries, embs, k, dtype=dtype, **kw)
    assert_matches_jax(ts, ti, js, ji, queries, embs, dtype=dtype)


@pytest.mark.parametrize("block_n,seg,per_seg", [
    (2048, 8, 3), (2048, 16, 2), (768, 24, 2), (1536, 48, 2),
    (1280, 80, 2), (1280, 640, 3), (2000, 1000, 1), (2048, 1024, 2),
    (2048, 2048, 5),
])
def test_twin_matches_jax_at_any_seg(block_n, seg, per_seg):
    """ROADMAP C-19: every seg that divides block_n, as JAX takes it:
    segments narrower than a warp, spans the card cuts short of a 128-row
    tile (lcm(seg, 128) > 512), and segments longer than 512 rows, which
    the card cuts into pieces and merges."""
    queries, embs, _ = _gaussian(seg + per_seg, 3, 5000, 16)
    pen = np.zeros(5000, np.float32)
    pen[::9] = -1e4
    kw = dict(block_n=block_n, seg=seg, per_seg=per_seg)
    ts, ti, js, ji = _run_both(queries, embs, 40, pen=pen, **kw)
    assert_matches_jax(ts, ti, js, ji, queries, embs, pen=pen)


def test_strip_wider_than_4096():
    """300,000 rows: a strip of 147·16·2 = 4,704 columns, which JAX cuts
    with `approx_max_k` before its exact `top_k`."""
    queries, embs, _ = _gaussian(3, 4, 300_000, 16)
    strip = seg_candidates_plain(torch.from_numpy(queries),
                                 torch.from_numpy(embs))
    assert strip[0].shape == (4, 4704)
    ts, ti, js, ji = _run_both(queries, embs, 40)
    assert_matches_jax(ts, ti, js, ji, queries, embs)
    assert (ti >= 0).all()


@pytest.mark.parametrize("pen_kind", ["full", "short", "inf"])
def test_penalty_matches_jax(pen_kind):
    """−1e4 on every 7th row and 60 random ones; "short" ends the penalty
    before N (JAX pads it with −5e29: those rows come back as id −1);
    "inf" puts −inf on whole segments, where the rounds after the first
    read the −1e30 that masks the first pick."""
    queries, embs, rng = _gaussian(11, 4, 3000, 32)
    pen = np.zeros(3000, np.float32)
    pen[::7] = -1e4
    pen[rng.choice(3000, 60, replace=False)] = -1e4
    if pen_kind == "short":
        pen = pen[:2500]
    if pen_kind == "inf":
        pen[:512] = -np.inf
    kw = dict(block_n=1024, seg=128, per_seg=2)
    ts, ti, js, ji = _run_both(queries, embs, 60, pen=pen, **kw)
    assert_matches_jax(ts, ti, js, ji, queries, embs, pen=pen)
    if pen_kind == "short":
        assert (ti < 2500).all()
    # every strip entry too, against the reference's masked extraction
    strip = seg_candidates_plain(torch.from_numpy(queries),
                                 torch.from_numpy(embs),
                                 penalty=torch.from_numpy(pen), **kw)
    k_all = strip[0].shape[1]
    ts, ti, js, ji = _run_both(queries, embs, k_all, pen=pen, **kw)
    assert_matches_jax(ts, ti, js, ji, queries, embs, pen=pen)
    assert sorted(ts[0].tolist(), reverse=True) == \
        sorted(strip[0][0].tolist(), reverse=True)


def test_k_wider_than_the_strip():
    """500 rows, 2 blocks of 4 segments, one round: a strip of 8; k = 20
    keeps 8 and pads 12 slots with (−1e30, −1)."""
    queries, embs, _ = _gaussian(5, 3, 500, 8)
    ts, ti, js, ji = _run_both(queries, embs, 20, block_n=256, seg=64,
                               per_seg=1)
    assert_matches_jax(ts, ti, js, ji, queries, embs)
    assert (ti[:, :8] >= 0).all() and (ti[:, 8:] == -1).all()
    assert (ts[:, 8:] == -1e30).all()


@pytest.mark.parametrize("n,block_n,seg,per_seg,width", [
    (20_000, 2048, 128, 2, 320),
    (20_000, 1024, 64, 3, 960),
    (300_000, 2048, 128, 2, 4704),   # approx_max_k's branch in JAX
    (300_000, 1024, 64, 1, 4688),
    (20_000, 2048, 1024, 8, 160),    # segments the card cuts into pieces
    (20_000, 2048, 8, 3, 7680),      # narrower than a warp
])
def test_planted_ties_keep_jax_order(n, block_n, seg, per_seg, width):
    """Rows of halves under constant queries: every sum is exact in any
    order, so ties are exact and the top 60 hold a few distinct scores.
    Ids and scores equal JAX's bit for bit: first lane in a segment, the
    lowest strip position among equal candidates."""
    rng = np.random.default_rng(n + seg + per_seg)
    embs = (rng.integers(-2, 3, (n, 16)) / 2).astype(np.float32)
    # equal best rows two to a segment in blocks 3 and 9: round 1 of a
    # segment comes after round 0 of the segments after it
    for blk in (9, 3):
        embs[blk * block_n + np.array([5, 6, 130, 131, 260, 261])] = 1.0
    queries = np.full((3, 16), 0.5, np.float32)
    queries[1] = -0.25
    queries[2, :8] = 1.0
    pen = np.zeros(n, np.float32)
    pen[::5] = -1e4
    kw = dict(block_n=block_n, seg=seg, per_seg=per_seg)
    strip = seg_candidates_plain(torch.from_numpy(queries),
                                 torch.from_numpy(embs),
                                 penalty=torch.from_numpy(pen), **kw)
    assert strip[0].shape[1] == width
    ts, ti, js, ji = _run_both(queries, embs, 60, pen=pen, **kw)
    assert max(len(np.unique(row)) for row in js) <= 10
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("n", [20_000, 300_000])
def test_zero_scores_below_and_above_4096(n):
    """The signed-zero hazard: JAX's `top_k` ranks +0.0 above −0.0 and
    the CPU `approx_max_k` ranks them equal. A −0.0 score never reaches
    the strip: the product of a zero query is +0.0 (a sum starts at +0.0)
    and +0.0 plus a −0.0 penalty is +0.0. So all-zero scores come in strip
    order in both packages, at widths 320 and 4,704."""
    embs = -np.abs(np.random.default_rng(2).standard_normal(
        (n, 16))).astype(np.float32)
    queries = np.zeros((2, 16), np.float32)
    pen = np.full(n, -0.0, np.float32)
    ts, ti, js, ji = _run_both(queries, embs, 40, pen=pen)
    np.testing.assert_array_equal(ti, ji)
    assert not np.signbit(js).any() and not np.signbit(ts).any()
    assert ti[0, :4].tolist() == [0, 128, 256, 384]


def test_all_equal_rows_come_in_strip_order():
    """Block-major, then round, then segment: round 0 of segments 0, 1, 2,
    then round 1 (JAX's layout with the lane padding dropped)."""
    q, e = np.ones((1, 8), np.float32), np.zeros((300, 8), np.float32)
    ts, ti, js, ji = _run_both(q, e, 6)
    assert ti[0].tolist() == ji[0].tolist() == [0, 128, 256, 1, 129, 257]


def test_plain_twin_counts_nothing_on_cpu():
    _kernels.reset_counts()
    fused_candidates_topk_plain(torch.ones((1, 8)), torch.ones((40, 8)), 2)
    assert _kernels.PLAIN_ON_CUDA["fused_candidates"] == 0
    assert _kernels.LAUNCHES["fused_candidates"] == 0
