"""The port's kernels past their former shape limits (ROADMAP C-17), on the
CPU: the launch plans as pure functions of the shapes, the input checks of
every kernel wrapper at each config that used to be refused, the zero-column
padding, and the store at those configs against the JAX package's store.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`); here the wrappers' checks, the plans they launch with and
the plain twins behind the same entry points are held to what the card
needs and to JAX.
"""

import numpy as np
import pytest
import torch

from rag_dpo_tpu.index import DeviceIndex as JDeviceIndex
from rag_dpo_tpu.index import IndexConfig as JIndexConfig
from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig
from rag_dpo_tpu_torch.ops.pooled import (
    _pooled_inputs,
    pooled_group_max_plain,
)
from rag_dpo_tpu_torch.ops.sparse import _ell_inputs
from rag_dpo_tpu_torch.ops.topk import (
    SMEM_MAX,
    TC_TILES,
    _dense_inputs,
    candidates_plan,
    fused_topk_plain,
    pad_columns,
    seg_candidates_plain,
    topk_plan,
)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the launch plans ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("k", [1, 40, 512, 4096])
@pytest.mark.parametrize("d", [8, 1000, 8192])
@pytest.mark.parametrize("q", [1, 7, 64, 300, 1024])
def test_topk_plan_fits_the_card(q, d, k, dtype):
    """K4's plan (the D loop needs none of it) fits a block's 232,448
    bytes of shared memory in both passes, with a wgmma N that is a
    multiple of 8 up to 256, a ring of 3 ... 8 slots, a grid the card
    takes, and chunks that cover every row."""
    n = max(k, 50_000)
    plan = topk_plan(q, n, k, DTYPES[dtype])
    assert plan["smem_bytes"] <= SMEM_MAX
    assert plan["merge_smem_bytes"] <= SMEM_MAX
    if dtype == "bf16":
        assert plan["route"] == "wgmma"
        assert plan["tile_q"] in TC_TILES
        assert plan["tile_q"] % 8 == 0 and plan["tile_q"] <= 256
        assert 3 <= plan["stages"] <= 8
    else:
        assert plan["route"] == "simt" and plan["tile_q"] in (16, 64)
    assert plan["rows_per_block"] % 128 == 0
    assert plan["n_chunks"] * plan["rows_per_block"] >= n
    assert (plan["n_chunks"] - 1) * plan["rows_per_block"] < n
    assert plan["n_chunks"] <= 65_535
    assert plan["q_tiles"] * plan["tile_q"] >= q


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("seg,block_n", [(32, 2048), (128, 2048),
                                         (384, 768), (512, 8192)])
@pytest.mark.parametrize("q", [1, 9, 300, 1024])
def test_candidates_plan_fits_the_card(q, seg, block_n, dtype):
    """K5's plan: a [tile, span] score tile and the ring fit, at every span
    the kernel takes (lcm(seg, 128) up to 512)."""
    plan = candidates_plan(q, 1_000_448, DTYPES[dtype], block_n=block_n,
                           seg=seg)
    assert plan["smem_bytes"] <= SMEM_MAX
    assert plan["span"] % seg == 0 and plan["span"] % 128 == 0
    assert 1 <= plan["n_blocks"] <= min(plan["n_spans"], 65_535)
    if dtype == "bf16":
        assert plan["tile_q"] in TC_TILES and 3 <= plan["stages"] <= 8


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("seg,block_n", [(8, 2048), (16, 2048), (24, 768),
                                         (48, 1536), (80, 1280), (640, 1280),
                                         (1000, 2000), (1024, 2048),
                                         (2048, 2048)])
@pytest.mark.parametrize("q", [1, 300])
def test_candidates_plan_admits_every_seg(q, seg, block_n, dtype):
    """ROADMAP C-19: K5 takes every seg that divides block_n. A span is at
    most 512 rows: whole segments up to seg 512, else one 512-row piece of
    a segment, whose picks a second pass merges from a scratch."""
    n = 1_000_448
    plan = candidates_plan(q, n, DTYPES[dtype], block_n=block_n, seg=seg)
    span, pieces = plan["span"], plan["pieces"]
    n_segs = -(-n // block_n) * (block_n // seg)
    assert plan["smem_bytes"] <= SMEM_MAX and span <= 512
    assert 1 <= plan["n_blocks"] <= min(plan["n_spans"], 65_535)
    if seg <= 512:
        assert pieces == 1 and span % seg == 0 and plan["scratch"] == 0
        assert (plan["n_spans"] - 1) * span < n_segs * seg
        assert plan["n_spans"] * span >= n_segs * seg
    else:
        assert span == 512 and (pieces - 1) * 512 < seg <= pieces * 512
        assert plan["n_spans"] == n_segs * pieces
        assert plan["scratch"] == q * n_segs * pieces


# (Q, LQ, C, LD, D) that K7 refused before it streamed D and walked the
# query tokens inside a block (C-22), beside the rerank's and the replay's
MAXSIM_SHAPES = [(1, 32, 40, 256, 1024), (1, 27, 40, 96, 32),
                 (1, 4, 3, 8, 16_384), (2, 9, 11, 70, 100),
                 (1, 129, 6, 90, 256), (65_536, 2, 3, 5, 8),
                 (1, 524_281, 1, 1, 16), (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("q,lq,c,ld,d", MAXSIM_SHAPES)
def test_maxsim_plan_takes_every_shape(q, lq, c, ld, d, dtype):
    """K7's plan fits a block's shared memory at any D (a ring of 2 to 6
    slices of 128 bytes of a doc row and the query tile's same columns),
    covers every doc row with 64-row blocks and every query token with
    32-token tiles walked inside a block: no grid dimension holds Q or LQ,
    and nothing holds all of D."""
    from rag_dpo_tpu_torch.ops.maxsim import maxsim_plan

    plan = maxsim_plan(dtype, q, lq, c, ld, d)
    itemsize = torch.finfo(dtype).bits // 8
    assert plan.slice * itemsize == 128
    assert 2 <= plan.stages <= 6
    assert plan.stages <= max(2, plan.query_tiles * -(-d // plan.slice))
    # a stage: TMA boxes of 64 doc rows and 32 query rows of 4·slice bytes,
    # after 1,024 bytes that align them
    assert plan.smem == 1024 + plan.stages * (64 * 128 + 32 * plan.slice * 4)
    # two blocks fit an SM's 228 KB with their static shared memory
    assert plan.smem <= 100_000 < SMEM_MAX
    assert plan.row_tiles * plan.row_tile >= ld > (plan.row_tiles - 1) * 64
    assert plan.query_tiles * plan.query_tile >= q * lq
    assert c * plan.row_tiles <= 2**31 - 1


def test_maxsim_plan_refuses_only_what_no_card_takes():
    from rag_dpo_tpu_torch.ops.maxsim import maxsim_plan

    for bad in ((torch.float32, 0, 4, 3, 8, 32),    # an empty axis
                (torch.float64, 1, 4, 3, 8, 32),    # rows the kernel lacks
                (torch.float16, 1, 1, 2**31 - 1, 65, 8)):  # 2³² blocks
        with pytest.raises(ValueError):
            maxsim_plan(*bad)


def test_large_k_lists_leave_shared_memory_only_at_the_smallest_tile():
    """The bf16 query tile halves while its lists fit no longer; only at
    8 queries do they go to the candidate scratch."""
    assert topk_plan(256, 10**6, 40, torch.bfloat16)["lists_in_smem"]
    p = topk_plan(256, 10**6, 512, torch.bfloat16)
    assert p["lists_in_smem"] and p["tile_q"] < 128
    p = topk_plan(256, 10**6, 4096, torch.bfloat16)
    assert not p["lists_in_smem"] and p["tile_q"] == 8
    assert not topk_plan(4, 10**6, 8192, torch.float32)["lists_in_smem"]


# ---- every config that reached a former limit ------------------------------

# (what reaches it, the wrapper and its former refusal) -> shapes
FORMER_LIMITS = {
    "retrieval.n_candidates 512 (k > 256: fused_topk)":
        ("dense", dict(q=4, n=2000, d=1024, k=512)),
    "retrieval.n_candidates 4096 (k > 256, lists off shared memory)":
        ("dense", dict(q=1, n=5000, d=64, k=4096)),
    "index dim 1536 (D > 1024: fused_topk, fused_candidates)":
        ("dense", dict(q=4, n=500, d=1536, k=40)),
    "index dim 1000 (D % 8: fused_topk, padded)":
        ("dense", dict(q=4, n=500, d=1000, k=40)),
    "a batch of 300 query variants (Q > 256)":
        ("dense", dict(q=300, n=500, d=64, k=40)),
    "int8 index dim 1536 (D > 1024: pooled_group_max)":
        ("pooled", dict(q=4, n=500, d=1536)),
    "int8 index dim 1000 (D % 16: pooled_group_max, padded)":
        ("pooled", dict(q=4, n=500, d=1000)),
    "max_query_terms 100, one variant (T > 64: ell_topk)":
        ("ell", dict(q=1, n=500, t=100)),
    "max_query_terms 128, one variant (the most the store sends ELL)":
        ("ell", dict(q=1, n=500, t=128)),
    "retrieval.n_candidates 2048 on the sparse arm (k > 1024: ell_topk)":
        ("ell", dict(q=1, n=5000, t=16, k=2048)),
}


@pytest.mark.parametrize("what", list(FORMER_LIMITS))
def test_every_former_limit_is_accepted(what):
    """The wrapper's checks take each config the JAX store serves and hand
    the kernel what it reads: a D it loads whole, contiguous aligned
    inputs."""
    kind, shape = FORMER_LIMITS[what]
    rng = np.random.default_rng(len(what))
    if kind == "dense":
        for dtype in DTYPES.values():
            q = torch.from_numpy(rng.standard_normal(
                (shape["q"], shape["d"])).astype(np.float32)).to(dtype)
            e = torch.from_numpy(rng.standard_normal(
                (shape["n"], shape["d"])).astype(np.float32)).to(dtype)
            qq, ee, pen = _dense_inputs("fused_topk", q, e,
                                        torch.zeros(shape["n"]))
            assert qq.shape[1] % 8 == 0 and ee.shape[1] == qq.shape[1]
            assert qq.is_contiguous() and ee.is_contiguous()
            plan = topk_plan(shape["q"], shape["n"],
                             min(shape["k"], shape["n"]), dtype)
            assert plan["smem_bytes"] <= SMEM_MAX
    elif kind == "pooled":
        q = torch.from_numpy(rng.standard_normal(
            (shape["q"], shape["d"])).astype(np.float32)).bfloat16()
        e = torch.from_numpy(rng.integers(
            -127, 128, (shape["n"], shape["d"])).astype(np.int8))
        qq, ee, scale, _ = _pooled_inputs(q, e, torch.ones(shape["n"]), None,
                                          8192, 64)
        assert ee.shape[1] % 16 == 0 and qq.shape[1] == ee.shape[1]
    else:
        args = _ell_inputs(
            torch.full((shape["n"], 8), -1, dtype=torch.int32),
            torch.zeros((shape["n"], 8)),
            torch.arange(shape["t"], dtype=torch.int32)[None, :],
            torch.ones((1, shape["t"])), shape.get("k", 40), 1024)
        assert args[2].shape == (shape["q"], shape["t"])


@pytest.mark.parametrize("bad", ["D differs", "empty", "dtypes", "f64",
                                 "devices"])
def test_dense_inputs_keep_only_the_refusals_jax_shares(bad):
    q, e = torch.zeros((2, 64)), torch.zeros((100, 64))
    args = {"D differs": (q[:, :60], e), "empty": (q[:0], e),
            "dtypes": (q.bfloat16(), e), "f64": (q.double(), e.double()),
            "devices": (q.to("meta"), e)}[bad]
    with pytest.raises(ValueError):
        _dense_inputs("fused_topk", *args, None)


# ---- the zero-column padding ---------------------------------------------


def _eighths(rng, shape):
    """Multiples of 1/8 in [-1, 1]: every sum of products of two is exact
    in f32 in any order, so padding can change no bit."""
    return (rng.integers(-8, 9, shape) / 8).astype(np.float32)


@pytest.mark.parametrize("d", [1000, 1001, 1535])
def test_zero_columns_change_no_bit_of_k4_or_k5(d):
    rng = np.random.default_rng(d)
    q = torch.from_numpy(_eighths(rng, (3, d)))
    e = torch.from_numpy(_eighths(rng, (3000, d)))
    pen = torch.zeros(3000)
    pen[::7] = -1e4
    qp, ep = pad_columns(q, 8), pad_columns(e, 8)
    assert qp.shape[1] % 8 == 0 and torch.equal(qp[:, :d], q)
    assert bool((qp[:, d:] == 0).all())
    for a, b in zip(fused_topk_plain(q, e, 40, penalty=pen),
                    fused_topk_plain(qp, ep, 40, penalty=pen)):
        assert torch.equal(a, b)
    for a, b in zip(seg_candidates_plain(q, e, penalty=pen),
                    seg_candidates_plain(qp, ep, penalty=pen)):
        assert torch.equal(a, b)


def test_zero_columns_change_no_bit_of_k6():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(_eighths(rng, (2, 1000))).bfloat16()
    e = torch.from_numpy(rng.integers(-8, 9, (4000, 1000)).astype(np.int8))
    scale = torch.full((4000,), 0.125)
    qp, ep, _, _ = _pooled_inputs(q, e, scale, None, 8192, 64)
    assert ep.shape[1] == 1008
    for a, b in zip(pooled_group_max_plain(q, e, scale),
                    pooled_group_max_plain(qp, ep, scale)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dim,int8", [(1000, False), (1000, True)])
def test_store_image_padding_changes_no_bit(dim, int8):
    """A store at a dim the kernels do not load whole pads its image and
    queries once; on rows of eighths its results are bit-equal to the
    unpadded twin's."""
    rng = np.random.default_rng(dim + int8)
    dense = _eighths(rng, (1500, dim))
    q = _eighths(rng, (2, dim))
    idx = DeviceIndex(IndexConfig(dim=dim, ell_width=4, quantize_int8=int8),
                      device="cpu")
    idx.add([f"r{i}" for i in range(1500)], dense)
    image = idx.device_image()
    wide = image["embs_i8" if int8 else "embs"]
    assert wide.shape[1] == (1008 if int8 else 1000)
    assert bool((wide[:, dim:] == 0).all())
    s, i = idx.search_dense(q, 40)
    if int8:
        return  # refined on the host f16 rows: the padding never reaches it
    qb = torch.from_numpy(q).bfloat16()
    e = torch.from_numpy(dense).to(torch.float16).bfloat16()
    ws, wi = fused_topk_plain(qb, e, 40, penalty=image["alive_penalty"])
    np.testing.assert_array_equal(i, wi.numpy())
    np.testing.assert_array_equal(s, ws.numpy())


# ---- the store at the former limits, against JAX ---------------------------


def _stores(dim, int8, n=6000):
    """Both packages' stores over the same rows, three unit queries and a
    100-term sparse query. Query i has 40 near neighbours, rows 40i ...
    40i + 39."""
    rng = np.random.default_rng(dim * 2 + int8)
    dense = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for i in range(3):
        noise = rng.standard_normal((40, dim)).astype(np.float32)
        dense[40 * i:40 * i + 40] = q[i] + 0.4 * noise / np.sqrt(dim)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    terms = ((rng.integers(0, 3000, (n, 1)) + 197 * np.arange(16)) % 3000
             ).astype(np.int32)
    imps = np.abs(rng.standard_normal((n, 16))).astype(np.float32)
    ids = [f"c{i}" for i in range(n)]
    jidx = JDeviceIndex(JIndexConfig(dim=dim, ell_width=16,
                                     quantize_int8=int8))
    idx = DeviceIndex(IndexConfig(dim=dim, ell_width=16, quantize_int8=int8),
                      device="cpu")
    for index in (jidx, idx):
        index.add(ids, dense, terms=terms, impacts=imps)
        index.delete([f"c{i}" for i in range(200, n, 53)])
    qt = rng.choice(3000, (1, 100), replace=False).astype(np.int32)
    qw = rng.uniform(0.2, 3.0, (1, 100)).astype(np.float32)
    return jidx, idx, q, qt, qw


@pytest.mark.parametrize("dim", [1000, 1536])
def test_bf16_store_past_former_limits_matches_jax(dim):
    """search_dense at k 512 (bf16 image, D 1000 padded or 1536): ids as
    JAX's but where two of JAX's scores lie within 1e-5 (the two packages
    round bf16 sums in other orders), scores within 1e-5."""
    jidx, idx, q, _, _ = _stores(dim, False)
    js, ji = jidx.search_dense(q, 512)
    ts, ti = idx.search_dense(q, 512)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    near = np.abs(np.diff(js, axis=1)) <= 1e-5
    near = np.pad(near, ((0, 0), (0, 1))) | np.pad(near, ((0, 0), (1, 0)))
    assert not ((ti != ji) & ~near).any()
    for i in range(3):
        assert set(ti[i, :40]) == set(range(40 * i, 40 * i + 40))


@pytest.mark.parametrize("dim", [1000, 1536])
def test_int8_store_past_former_limits_matches_jax(dim):
    """search_dense at k 512 on int8 images: both stores rank by int8 ×
    int8 and refine exactly on the host (ROADMAP C-14), so the port returns
    JAX's ids and scores, each query's 40 planted neighbours first, and
    every score is the f32 dot against the row's f16 copy (within 1e-6)."""
    jidx, idx, q, _, _ = _stores(dim, True)
    js, ji = jidx.search_dense(q, 512)
    ts, ti = idx.search_dense(q, 512)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    for i in range(3):
        assert set(ti[i, :40]) == set(range(40 * i, 40 * i + 40))
    ok = ti >= 0
    exact = np.einsum("qd,qkd->qk", q,
                      idx._dense[np.where(ok, ti, 0)].astype(np.float32))
    np.testing.assert_allclose(ts[ok], exact[ok], rtol=0, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_sparse_search_with_100_terms_matches_jax(int8):
    """search_sparse with one variant of 100 terms (Q·T ≤ 128: the ELL
    path, which took 64 terms at most): ids and scores exactly JAX's."""
    jidx, idx, _, qt, qw = _stores(1536, int8, n=3000)
    js, ji = jidx.search_sparse(qt, qw, 40)
    ts, ti = idx.search_sparse(qt, qw, 40)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
