"""Parity of the PyTorch port's ops with the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernels in interpret mode on the CPU) and the port, whose wrappers
take their plain twins for CPU tensors. The CUDA kernels themselves are
held to those twins on the card by `chip_smoke.py` and by
`tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.ops import flash_attention_bwd as jflash_bwd
from rag_dpo_tpu.ops.flash_attention import attention_reference as j_attn_ref
from rag_dpo_tpu.ops.fusion import rrf_fuse as j_rrf_fuse
from rag_dpo_tpu.ops.sparse import ell_topk as j_ell_topk
from rag_dpo_tpu.ops.topk import approx_topk as j_approx_topk
from rag_dpo_tpu.ops.topk import blocked_topk as j_blocked_topk
from rag_dpo_tpu_torch.ops import _kernels
from rag_dpo_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
)
from rag_dpo_tpu_torch.ops.causal_attention import causal_attention
from rag_dpo_tpu_torch.ops.flash_attention_bwd import flash_attention_fused
from rag_dpo_tpu_torch.ops.fusion import rrf_fuse, rrf_fuse_reference
from rag_dpo_tpu_torch.ops.int8_matmul import int8_block_max
from rag_dpo_tpu_torch.ops.maxsim import maxsim
from rag_dpo_tpu_torch.ops.pooled import pooled_group_max
from rag_dpo_tpu_torch.ops.sparse import (
    ell_order_keys,
    ell_scores,
    ell_scores_reference,
    ell_topk,
)
from rag_dpo_tpu_torch.ops.topk import (
    approx_topk,
    blocked_topk,
    cosine_topk_reference,
    fused_candidates_topk,
    fused_topk,
    streaming_topk_reference,
)

torch.backends.cuda.matmul.allow_tf32 = False

# f32 flash: the Pallas forward streams 16-key blocks here and the twin
# takes one block, so the online-softmax rescales round differently; both
# accumulate in f32 over ≤ 40 keys, which keeps them within ~1e-6.
FLASH_TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(rng, b, h, s, dh):
    return [rng.standard_normal((b, h, s, dh)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("s,lengths", [(40, [40, 17, 0]), (24, [5, 24, 1])])
def test_flash_plain_matches_jax_fused_forward_and_lse(s, lengths):
    rng = np.random.default_rng(s)
    q, k, v = _qkv(rng, 3, 2, s, 16)
    lens = np.asarray(lengths, np.int32)
    scale = 16 ** -0.5
    j_out, j_lse, _ = jflash_bwd._fwd_with_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        scale, 16, 16, True)
    j_fused = jflash_bwd.flash_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_q=16, block_k=16)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = flash_attention(*t, torch.from_numpy(lens), return_lse=True)
    assert out.shape == (3, 2, s, 16) and lse.shape == (3, 2, s, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FLASH_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_fused), **FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, :s],
                               **FLASH_TOL)
    if 0 in lengths:  # fully masked row: 0 output, lse clamped at -1e20
        z = lengths.index(0)
        assert np.all(out.numpy()[z] == 0.0)
        assert np.all(lse.numpy()[z] == np.float32(-1e20))
    # rows with keys also match the plain softmax oracle of both packages
    live = [i for i, n in enumerate(lengths) if n > 0]
    ref = attention_reference(*t, torch.from_numpy(lens)).numpy()
    j_ref = np.asarray(j_attn_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                  jnp.asarray(lens)))
    np.testing.assert_allclose(ref, j_ref, **FLASH_TOL)
    np.testing.assert_allclose(out.numpy()[live], ref[live], **FLASH_TOL)


def test_flash_without_lengths_and_bf16_plain():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 2, 20, 32)
    j_out = jflash_bwd.flash_attention_fused(
        *(jnp.asarray(x) for x in (q, k, v)), block_q=20, block_k=20)
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FLASH_TOL)
    # bf16 in, bf16 out, f32 inside: the one cast at the end dominates
    qb = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    outb = flash_attention(*qb)
    assert outb.dtype == torch.bfloat16
    ref = attention_reference(*(x.float() for x in qb))
    np.testing.assert_allclose(outb.float().numpy(), ref.numpy(),
                               atol=2e-2, rtol=2e-2)


def _ell_case(rng, n, l, q, t, vocab):
    terms = np.full((n, l), -1, np.int32)
    imps = np.zeros((n, l), np.float32)
    for i in range(n):
        w = rng.integers(0, l + 1)
        terms[i, :w] = rng.choice(vocab, size=w, replace=False)
        imps[i, :w] = rng.uniform(0.1, 2.5, size=w)
    qt = np.full((q, t), -2, np.int32)
    qw = np.zeros((q, t), np.float32)
    for i in range(q):
        w = rng.integers(1, t + 1)
        qt[i, :w] = rng.choice(vocab, size=w, replace=False)
        qw[i, :w] = rng.uniform(0.2, 3.0, size=w)
    return terms, imps, qt, qw


def _both_ell(terms, imps, qt, qw, k):
    js, ji = j_ell_topk(*(jnp.asarray(x) for x in (terms, imps, qt, qw)),
                        k=k)
    ts, ti = ell_topk(*(torch.from_numpy(x) for x in (terms, imps, qt, qw)),
                      k=k)
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


@pytest.mark.parametrize("n,vocab,k", [(2500, 60, 40), (700, 400, 40),
                                       (30, 20, 40)])
def test_ell_topk_plain_matches_jax_ids_exact(n, vocab, k):
    rng = np.random.default_rng(n)
    terms, imps, qt, qw = _ell_case(rng, n, 8, 3, 6, vocab)
    (js, ji), (ts, ti) = _both_ell(terms, imps, qt, qw, k)
    np.testing.assert_array_equal(ti, ji)   # ids exact, ties included
    np.testing.assert_array_equal(ts, js)   # exact sums in t order
    # scores also agree with the full-matrix oracle
    full = ell_scores_reference(
        *(torch.from_numpy(x) for x in (terms, imps, qt, qw))).numpy()
    blocked = ell_scores(
        *(torch.from_numpy(x) for x in (terms, imps, qt, qw))).numpy()
    np.testing.assert_allclose(blocked, full, rtol=1e-6, atol=1e-6)


def test_ell_tie_probes_follow_reference_order():
    # C-1 probe 1: 212 rows, one query term, 12 hits; zero rows fill the
    # remaining slots in (block, round, segment) order
    n = 212
    terms = np.full((n, 4), -1, np.int32)
    imps = np.zeros((n, 4), np.float32)
    hits = [1, 2, 5, 9, 40, 77, 100, 127, 130, 150, 190, 211]
    for r in hits:
        terms[r, 0] = 7
        imps[r, 0] = 1.0 + (r % 3)
    qt = np.asarray([[7, -2]], np.int32)
    qw = np.asarray([[1.5, 0.0]], np.float32)
    (js, ji), (ts, ti) = _both_ell(terms, imps, qt, qw, 40)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    # C-1 probe 2: 300 rows that all score 0
    terms = np.full((300, 4), -1, np.int32)
    imps = np.zeros((300, 4), np.float32)
    (js, ji), (ts, ti) = _both_ell(terms, imps, qt, qw, 40)
    np.testing.assert_array_equal(ti, ji)
    assert ti[0, :6].tolist() == [0, 128, 256, 1, 129, 257]


def test_ell_topk_padded_rows_compete_in_zero_fill():
    # the index passes its whole padded image (-1 terms past n_rows)
    rng = np.random.default_rng(5)
    terms, imps, qt, qw = _ell_case(rng, 300, 6, 2, 4, 3000)
    pad_terms = np.full((1024, 6), -1, np.int32)
    pad_imps = np.zeros((1024, 6), np.float32)
    pad_terms[:300], pad_imps[:300] = terms, imps
    (js, ji), (ts, ti) = _both_ell(pad_terms, pad_imps, qt, qw, 40)
    np.testing.assert_array_equal(ti, ji)
    assert (ti >= 300).any()  # padded rows do reach the zero fill


def test_streaming_reference_small_k_and_invalid_tail():
    s = torch.zeros((1, 10))
    top, ids = streaming_topk_reference(s, 4, block_n=8, seg=4, n_valid=6)
    # rows 6.. are empty; segments 0-3, 4-7 | 8-11
    assert ids[0].tolist() == [0, 4, 1, 5]
    top, ids = streaming_topk_reference(s, 8, block_n=8, seg=4, n_valid=6)
    assert ids[0].tolist()[-2:] == [-1, -1]
    assert top[0, -1] == np.float32(-1e30)


@pytest.mark.parametrize("n,block_n,seg", [
    (3000, 1024, 128),   # the kernel's blocks, three and a partial one
    (1024, 1024, 128),   # the hermetic replay's one block
    (130, 1024, 128),    # a partial segment
    (2000, 256, 32),     # other block and segment widths
])
def test_ell_order_keys_follow_the_streaming_order(n, block_n, seg):
    """The ELL kernel's 64-bit key (`ell_order_keys`, its host mirror):
    unique in a query, and its descending order is the reference's
    streaming order on scores with planted ties across blocks, rounds and
    segments, ±0.0 among them (equal to each other), and rows past N."""
    rng = np.random.default_rng(n + block_n)
    s = rng.integers(-3, 4, (4, n)).astype(np.float32) * 0.5
    zero = s == 0
    s[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    s[1] = 0.0                          # a query of equal scores
    s[2, ::7] = 1e30                    # huge ties, below them the rest
    scores = torch.from_numpy(s)
    key = ell_order_keys(scores, block_n=block_n, seg=seg)
    assert key.dtype == torch.int64 and key.shape == (4, n)
    assert all(len(set(row.tolist())) == n for row in key)
    k = min(n, -(-n // block_n) * block_n)
    _, want = streaming_topk_reference(scores, k, block_n=block_n, seg=seg)
    order = torch.argsort(key, dim=1, descending=True)
    assert torch.equal(order[:, :k].int(), want)


def _dense_case(rng, n=600, d=16, q=3):
    embs = rng.standard_normal((n, d)).astype(np.float32)
    embs[50] = embs[10]          # exact duplicate rows → exact ties
    embs[400] = embs[10]
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries[1] = embs[10]
    pen = np.zeros((n,), np.float32)
    pen[rng.choice(n, 60, replace=False)] = -1e4
    return queries, embs, pen


def test_dense_topk_with_penalty_matches_jax():
    rng = np.random.default_rng(3)
    queries, embs, pen = _dense_case(rng)
    jq, je, jp = (jnp.asarray(x) for x in (queries, embs, pen))
    tq, te, tp = (torch.from_numpy(x) for x in (queries, embs, pen))
    js, ji = j_blocked_topk(jq, je, 40, block_n=256, penalty=jp)
    ts, ti = blocked_topk(tq, te, 40, block_n=256, penalty=tp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    js, ji = j_approx_topk(jq, je, 40, penalty=jp)
    ts, ti = approx_topk(tq, te, 40, penalty=tp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    # the three selectors agree where no penalty applies
    cs, ci = cosine_topk_reference(tq, te, 40)
    bs, bi = blocked_topk(tq, te, 40, block_n=128)
    np.testing.assert_array_equal(ci.numpy(), bi.numpy())
    # corpus smaller than k pads with (-1e30, -1)
    ts, ti = approx_topk(tq, te[:5], 8)
    assert ti[:, 5:].eq(-1).all() and ts[:, 5:].eq(-1e30).all()


def test_rrf_fuse_exact_ties_keep_first_occurrence():
    # four arms; ids 3/4 and 5/6 collect identical contributions, so their
    # fused scores tie exactly and first occurrence must decide
    arms = np.asarray([
        [3, 4, 1, 2, -1],
        [4, 3, 2, 1, 7],
        [5, 6, 9, -1, -1],
        [6, 5, 8, 9, 1],
    ], np.int32)[:, None, :]
    weights = np.asarray([2.0, 2.0, 1.0, 1.0], np.float32)
    js, ji = j_rrf_fuse(jnp.asarray(arms), jnp.asarray(weights), topk=12)
    ts, ti = rrf_fuse(torch.from_numpy(arms), torch.from_numpy(weights),
                      topk=12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    order = ti[0].tolist()
    assert ts[0, order.index(3)] == ts[0, order.index(4)]
    assert order.index(3) + 1 == order.index(4)
    assert order.index(5) + 1 == order.index(6)
    ref = rrf_fuse_reference([list(a[0]) for a in arms], weights)
    for cid, score in zip(ti[0].tolist(), ts[0].tolist()):
        if cid >= 0:
            assert abs(ref[cid] - score) < 1e-6


def test_rrf_fuse_random_arms_match_jax():
    rng = np.random.default_rng(11)
    arms = rng.integers(-1, 30, size=(6, 2, 40)).astype(np.int32)
    weights = np.asarray([2.0, 1.0, 1.0, 1.5, 0.75, 0.75], np.float32)
    js, ji = j_rrf_fuse(jnp.asarray(arms), jnp.asarray(weights), topk=50)
    ts, ti = rrf_fuse(torch.from_numpy(arms), torch.from_numpy(weights),
                      topk=50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_wrappers_take_plain_twin_on_cpu_without_launching():
    _kernels.reset_counts()
    x = torch.zeros((1, 1, 4, 16))
    flash_attention(x, x, x)
    q = x.clone().requires_grad_()
    flash_attention_fused(q, q, q).sum().backward()  # dq and dk/dv twins
    ell_topk(torch.full((4, 2), -1, dtype=torch.int32), torch.zeros((4, 2)),
             torch.full((1, 2), -2, dtype=torch.int32), torch.zeros((1, 2)),
             k=2)
    maxsim(torch.zeros((1, 3, 8)), torch.ones((1, 3), dtype=torch.bool),
           torch.zeros((2, 4, 8), dtype=torch.float16),
           torch.ones((2, 4), dtype=torch.bool))
    fused_topk(torch.zeros((2, 8)), torch.zeros((5, 8)), 3)
    pooled_group_max(torch.zeros((2, 16), dtype=torch.bfloat16),
                     torch.zeros((40, 16), dtype=torch.int8), torch.ones(40),
                     block_n=16, group=4)
    fused_candidates_topk(torch.zeros((2, 8)), torch.zeros((300, 8)), 5)
    for upcast in ("bf16", "int8"):
        int8_block_max(torch.zeros((2, 16), dtype=torch.int8),
                       torch.zeros((300, 16), dtype=torch.int8), block=128,
                       upcast=upcast)
    # a prefill's 64 (position, head) rows: the kernel's tile on the card
    causal_attention(torch.zeros((1, 32, 4, 16)), torch.zeros((1, 32, 2, 16)),
                     torch.zeros((1, 32, 2, 16)), torch.arange(32)[None])
    none = {name: 0 for name in ("flash_fwd", "ell_topk", "flash_bwd_dq",
                                 "flash_bwd_dkv", "maxsim", "fused_topk",
                                 "pooled_max", "fused_candidates",
                                 "int8_block_max_bf16", "int8_block_max_i8",
                                 "flash_prefill")}
    assert _kernels.LAUNCHES == none
    assert _kernels.PLAIN_ON_CUDA == none


def test_default_device_raises_without_a_card(monkeypatch):
    """No quiet fall back to the CPU: an entry point with no device asks
    for the card, and a CPU run must say `device="cpu"`."""
    from rag_dpo_tpu_torch.ops import default_device
    from rag_dpo_tpu_torch.providers import Embedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Embedder()
    assert default_device("cpu") == torch.device("cpu")
    assert Embedder(device="cpu").device == torch.device("cpu")
