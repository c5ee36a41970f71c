"""K4 (`fused_topk`) of the port against the JAX package, on the CPU.

The port's wrapper takes its plain twin here (a matmul, the penalty and a
stable sort); the CUDA kernel is held to that twin on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`. The JAX `fused_topk` runs
its Pallas kernel in interpret mode.

Order among equal scores: the port keeps the lowest row first, as the
store's selectors `lax.top_k` / CPU `approx_max_k` do; the JAX Pallas
kernel emits ties in its streaming order instead (ROADMAP C-1, C-13). So
the JAX kernel is compared on tie-free inputs, and ties are held to
`blocked_topk`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.ops.topk import blocked_topk as j_blocked_topk
from rag_dpo_tpu.ops.topk import fused_topk as j_fused_topk
from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.ops.topk import (
    approx_topk,
    blocked_topk,
    fused_topk,
    fused_topk_plain,
)

# scores are f32 sums of D ≤ 64 products in another order than XLA's
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("q,n,d,k,dtype", [
    (3, 1500, 32, 40, np.float32),   # N not a multiple of the block
    (5, 700, 64, 50, np.float32),
    (2, 30, 16, 40, np.float32),     # k > N: (-1e30, -1) fill
    (1, 2049, 8, 1, np.float32),
    (9, 1100, 24, 160, np.float32),  # the int8 arm's 4k
    (4, 900, 32, 40, "bfloat16"),
])
def test_twin_matches_jax_fused_topk_tie_free(q, n, d, k, dtype):
    rng = np.random.default_rng(q * n + k)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    embs = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "bfloat16":
        jq, je = (jnp.asarray(x).astype(jnp.bfloat16)
                  for x in (queries, embs))
        tq, te = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (queries, embs))
    else:
        jq, je = jnp.asarray(queries), jnp.asarray(embs)
        tq, te = torch.from_numpy(queries), torch.from_numpy(embs)
    js, ji = j_fused_topk(jq, je, k, block_n=256, tile_q=8)
    ts, ti = fused_topk(tq, te, k)
    assert ti.dtype == torch.int32 and ts.shape == (q, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)
    if k > n:
        assert (ti[:, n:] == -1).all() and (ts[:, n:] == -1e30).all()


@pytest.mark.parametrize("pen_len", ["full", "short", None])
def test_ties_and_penalty_match_jax_blocked_topk(pen_len):
    """Planted duplicate rows tie exactly; the lowest row comes first."""
    rng = np.random.default_rng(7)
    n, d = 1000, 16
    embs = rng.standard_normal((n, d)).astype(np.float32)
    embs[[501, 900, 77]] = embs[3]        # four equal rows
    embs[600:620] = embs[20]
    queries = rng.standard_normal((4, d)).astype(np.float32)
    queries[1] = embs[3]
    queries[2] = embs[20]
    pen = np.zeros(n, np.float32)
    pen[rng.choice(n, 80, replace=False)] = -1e4
    pen[[900, 605]] = -1e4
    if pen_len == "short":
        pen = pen[:950]                   # rows 950.. count -5e29
    jp = None if pen_len is None else jnp.asarray(pen)
    tp = None if pen_len is None else torch.from_numpy(pen)
    js, ji = j_blocked_topk(jnp.asarray(queries), jnp.asarray(embs), 40,
                            block_n=256, penalty=jp)
    tq, te = torch.from_numpy(queries), torch.from_numpy(embs)
    for s, i in (fused_topk(tq, te, 40, penalty=tp),
                 blocked_topk(tq, te, 40, block_n=256, penalty=tp)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCORE_TOL)
    ids = fused_topk(tq, te, 40, penalty=tp)[1]
    if pen_len is not None:   # the equal rows, lowest first, 900 penalised
        assert ids[1, :3].tolist() == [3, 77, 501]
        assert ids[2, :4].tolist() == [20, 600, 601, 602]
    if pen_len != "short":    # approx_topk needs a full-length penalty
        s, i = approx_topk(tq, te, 40, penalty=tp)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_all_equal_rows_come_lowest_first_c13():
    """The store's order (C-13): the JAX Pallas kernel's streaming order
    would give 0, 128, 256, 1, ... (C-1)."""
    q = torch.ones((1, 8))
    e = torch.zeros((300, 8))
    s, i = fused_topk(q, e, 6)
    assert i[0].tolist() == [0, 1, 2, 3, 4, 5]
    js, ji = j_blocked_topk(jnp.ones((1, 8)), jnp.zeros((300, 8)), 6)
    assert np.asarray(ji)[0].tolist() == i[0].tolist()


def test_blocked_and_approx_keep_their_fill_slots():
    """What the store's `_finish`/`_strip_dead` see when k > N: blocked's
    running merge fills (-1e30, 0), approx and fused (-1e30, -1)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    bs, bi = blocked_topk(q, e, 8)
    js, ji = j_blocked_topk(jnp.asarray(q.numpy()), jnp.asarray(e.numpy()), 8)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
    assert (bi[:, 5:] == 0).all() and (bs[:, 5:] == -1e30).all()
    s, i = approx_topk(q, e, 8)
    fs, fi = fused_topk(q, e, 8)
    assert torch.equal(i, fi) and torch.equal(s, fs)
    assert (fi[:, 5:] == -1).all()


def test_plain_twin_counts_nothing_on_cpu():
    _kernels.reset_counts()
    fused_topk_plain(torch.ones((1, 8)), torch.ones((4, 8)), 2)
    assert _kernels.PLAIN_ON_CUDA["fused_topk"] == 0
    assert _kernels.LAUNCHES["fused_topk"] == 0
