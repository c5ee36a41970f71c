"""K6 (`pooled_group_max`) and int8 quantization of the port against the JAX
package, on the CPU.

The port's wrapper takes its plain twin here; the CUDA kernel is held to
that twin on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
The JAX `pooled_group_max` runs its Pallas kernel in interpret mode.

Tolerances: the pooled values are bf16 roundings of f32 sums taken in
another order (and the scale and penalty maybe fused by XLA), so they agree
within one bf16 ulp; a group's argmax may differ only where its two best
f32 scores lie within 1e-5 of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.ops.pooled import pooled_group_max as j_pooled_group_max
from rag_dpo_tpu.ops.pooled import pooled_topk_int8 as j_pooled_topk_int8
from rag_dpo_tpu.ops.quantize import quantize_rows as j_quantize_rows
from rag_dpo_tpu_torch.ops.pooled import (
    pooled_group_max,
    pooled_group_max_plain,
    pooled_topk_int8,
)
from rag_dpo_tpu_torch.ops.quantize import quantize_rows

NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


def test_quantize_rows_bit_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((300, 48)) * 3).astype(np.float32)
    x[0] = 0.0                               # scale floor 1e-12 / 127
    x[1] = np.linspace(-1, 1, 48)
    x[2, :4] = [127.0, 0.5, 1.5, -2.5]       # halves: round to even
    x[2, 4:] = 0.0
    x[3] = 1e-30
    jq, js = j_quantize_rows(jnp.asarray(x))
    tq, ts = quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert tq[2, :4].tolist() == [127, 0, 2, -2]
    # a numpy array in gives the same
    nq, _ = quantize_rows(x)
    assert torch.equal(nq, tq)


def _int8_case(rng, n, d, q):
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e_i8, e_scale = (np.array(a) for a in j_quantize_rows(jnp.asarray(e)))
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return e, e_i8, e_scale, queries


def _scores_f32(queries, e_i8, e_scale, pen, n_pad):
    qb = torch.from_numpy(queries).to(torch.bfloat16).float().numpy()
    s = (qb @ e_i8.astype(np.float32).T) * e_scale[None, :]
    full = np.full((queries.shape[0], n_pad), -1e30, np.float32)
    full[:, : e_i8.shape[0]] = s
    if pen is not None:
        p = np.full(n_pad, -5e29, np.float32)
        p[: len(pen)] = pen
        full[:, : e_i8.shape[0]] += p[: e_i8.shape[0]]
    return full


def _assert_pooled_close(tv, ti, jv, ji, s_f32, block_n, group):
    tv, jv = tv.float().numpy(), np.asarray(jv.astype(jnp.float32))
    ti, ji = ti.numpy(), np.asarray(ji)
    assert tv.shape == jv.shape and ti.shape == ji.shape
    assert (np.abs(tv - jv) <= _bf16_ulp(jv)).all()
    q, n_pad = s_f32.shape
    ng = block_n // group
    s4 = s_f32.reshape(q, n_pad // block_n, group, ng)
    top2 = -np.sort(-s4, axis=2)[:, :, :2, :]
    near = (top2[:, :, 0] - top2[:, :, 1] <= NEAR_TIE).reshape(q, -1)
    differ = ti != ji
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]
    return int(differ.sum())


@pytest.mark.parametrize("n,block_n,group,pen", [
    (3000, 1024, 8, None),       # ragged N, small blocks
    (3000, 1024, 8, "full"),
    (2500, 1024, 8, "short"),    # rows past the penalty count -5e29
    (9000, 8192, 64, "full"),    # the store's defaults, two blocks
    (700, 256, 2, "full"),       # (block_n / group) % 128 != 0: no longer refused
])
def test_pooled_twin_matches_jax(n, block_n, group, pen):
    rng = np.random.default_rng(n + group)
    _, e_i8, e_scale, queries = _int8_case(rng, n, 32, 5)
    p = None
    if pen is not None:
        p = np.zeros(n if pen == "full" else n - 300, np.float32)
        p[rng.choice(len(p), len(p) // 10, replace=False)] = -1e4
    qb = jnp.asarray(queries).astype(jnp.bfloat16)
    if (block_n // group) % 128:
        with pytest.raises(ValueError):    # the reference's Mosaic check
            j_pooled_group_max(qb, jnp.asarray(e_i8), jnp.asarray(e_scale),
                               None if p is None else jnp.asarray(p),
                               block_n=block_n, group=group)
        tv, ti = pooled_group_max(torch.from_numpy(queries).to(torch.bfloat16),
                                  torch.from_numpy(e_i8),
                                  torch.from_numpy(e_scale),
                                  torch.from_numpy(p), block_n=block_n,
                                  group=group)
        s = _scores_f32(queries, e_i8, e_scale, p, -(-n // block_n) * block_n)
        ng = block_n // group
        s4 = s.reshape(5, -1, group, ng)
        want = np.where(s4.max(axis=2) > -5e29,
                        np.arange(s4.shape[1])[None, :, None] * block_n
                        + s4.argmax(axis=2) * ng + np.arange(ng), -1)
        np.testing.assert_array_equal(ti.numpy(), want.reshape(5, -1))
        return
    jv, ji = j_pooled_group_max(qb, jnp.asarray(e_i8), jnp.asarray(e_scale),
                                None if p is None else jnp.asarray(p),
                                block_n=block_n, group=group)
    tv, ti = pooled_group_max(torch.from_numpy(queries).to(torch.bfloat16),
                              torch.from_numpy(e_i8),
                              torch.from_numpy(e_scale),
                              None if p is None else torch.from_numpy(p),
                              block_n=block_n, group=group)
    s = _scores_f32(queries, e_i8, e_scale, p, jv.shape[1] * group)
    _assert_pooled_close(tv, ti, jv, ji, s, block_n, group)


def test_pooled_group_max_rejects_bad_blocks():
    x = torch.zeros((1, 16), dtype=torch.bfloat16)
    e = torch.zeros((64, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        pooled_group_max_plain(x, e, torch.ones(64), block_n=100, group=64)


def test_pooled_topk_int8_matches_jax():
    rng = np.random.default_rng(5)
    e, e_i8, e_scale, queries = _int8_case(rng, 6000, 32, 6)
    e_ref = e.astype(np.float16).astype(np.float32)
    pen = np.zeros(6000, np.float32)
    pen[rng.choice(6000, 500, replace=False)] = -1e4
    js, ji = j_pooled_topk_int8(
        jnp.asarray(queries), jnp.asarray(e_i8), jnp.asarray(e_scale),
        jnp.asarray(e_ref), 20, penalty=jnp.asarray(pen), block_n=1024,
        group=8)
    ts, ti = pooled_topk_int8(
        torch.from_numpy(queries), torch.from_numpy(e_i8),
        torch.from_numpy(e_scale), torch.from_numpy(e_ref), 20,
        penalty=torch.from_numpy(pen), block_n=1024, group=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    assert not np.isin(ti.numpy(), np.nonzero(pen)[0]).any()


# (Q, D) of every K6 case of tests/test_torch_cuda.py and chip_smoke.py
K6_CUDA_SHAPES = [
    (4, 1024), (1, 64), (70, 128), (3, 32), (2, 16), (256, 1024),
    (4, 1536), (3, 1000), (1, 128), (16, 128), (17, 1024), (64, 1024),
    (65, 256), (128, 512), (129, 1536), (300, 48), (5, 16), (70, 1000),
    (3, 1536), (33, 64), (2, 32), (40, 128), (200, 256), (7, 1536),
    (300, 1536), (64, 1536), (1, 1024),
]


@pytest.mark.parametrize("q,d", K6_CUDA_SHAPES)
def test_widen_plan_of_every_k6_shape(q, d):
    """K6's plan: 16 queries a block up to Q 16, else 64 (ceil(Q / 64) query
    tiles), its bf16 queries in the ring beside the rows, the deepest ring
    that fits the block's shared memory (up to 8 stages)."""
    from rag_dpo_tpu_torch.ops import widen_product as wp

    p = wp.widen_plan(q, d)
    assert p.nq == (16 if q <= 16 else 64) and not p.resident
    d_pad = -(-d // 16) * 16
    assert (p.chunks - 1) * 128 < d_pad <= p.chunks * 128
    assert 2 <= p.stages <= wp.MAX_STAGES and p.smem <= wp.MAX_SMEM
    assert p.stages == wp.MAX_STAGES or wp.smem_bytes(
        p.nq, p.stages + 1, False, p.chunks) > wp.MAX_SMEM


@pytest.mark.parametrize("d", [16, 48, 128, 1000, 1024, 1040, 1536, 6144])
def test_widen_plan_fits_any_batch(d):
    """Every Q from 1 to 1024, for K6 and K10, fits the block's shared
    memory; the bytes add up as the header lays them out."""
    from rag_dpo_tpu_torch.ops import widen_product as wp

    for q in range(1, 1025):
        for int8_queries in (False, True):
            p = wp.widen_plan(q, d, int8_queries=int8_queries)
            assert p.smem <= wp.MAX_SMEM and p.stages >= 2
            assert p.resident == int8_queries
            q_bytes = p.nq * 128 * 2
            assert p.smem == (1024 + p.stages * (128 * 128 + (
                0 if p.resident else q_bytes))
                + (p.chunks * q_bytes if p.resident else 0) + 128)
    # the recipe's plans at 1M × 1024
    if d == 1024:
        assert wp.widen_plan(1, d) == wp.WidenPlan(16, 8, False, 8)
        assert wp.widen_plan(64, d) == wp.WidenPlan(64, 7, False, 8)
        assert wp.widen_plan(256, d) == wp.WidenPlan(64, 7, False, 8)
        assert wp.widen_plan(64, d, int8_queries=True) == wp.WidenPlan(
            64, 6, True, 8)


def test_widen_plan_refuses_nonsense():
    from rag_dpo_tpu_torch.ops.widen_product import widen_plan

    for q, d in ((0, 64), (4, 0), (-1, 64)):
        with pytest.raises(ValueError):
            widen_plan(q, d)
    with pytest.raises(ValueError):   # K10's query tile past shared memory
        widen_plan(64, 6160, int8_queries=True)


@pytest.mark.parametrize("d", [16, 48, 64, 100, 1000, 1024, 1536])
def test_query_columns_permute_and_back(d):
    """K6's queries go to the kernel with their columns permuted to the
    lanes' k order: column d at query_col(d), zero columns past D; the
    inverse gives the bits back."""
    from rag_dpo_tpu_torch.ops.widen_product import permute_columns, query_col

    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
    x = x.to(torch.bfloat16)
    p = permute_columns(x)
    dp = -(-d // 64) * 64
    assert p.shape == (5, dp) and p.dtype == torch.bfloat16
    cols = torch.tensor([query_col(c) for c in range(d)])
    assert torch.equal(p[:, cols], x)
    assert sorted(query_col(c) for c in range(dp)) == list(range(dp))
    # the inverse: [Q, b, s, jh, t, jl] → [Q, b, t, s, jh, jl]
    back = p.reshape(5, dp // 64, 4, 2, 4, 2).permute(0, 1, 4, 2, 3, 5)
    back = back.reshape(5, dp)
    assert torch.equal(back[:, :d], x) and not back[:, d:].any()
    # the k step and slot each column lands in, as the lanes fill them
    for c in range(dp):
        t, s, j = (c >> 4) & 3, (c >> 2) & 3, c & 3
        col = query_col(c) % 64
        assert col // 16 == s and col % 16 == 2 * t + (j & 1) + 8 * (j >> 1)
