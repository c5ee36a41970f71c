"""The port's row-sharded store on 2 and 4 gloo ranks against the JAX
package's single-device oracle and its 8-device mesh
(`tests/test_sharded_hybrid.py`'s cases, with its tolerances: bf16 dense
2e-2, int8 1e-3, sparse 1e-4; ids equal; `rrf_fuse` over the arms equal
ids and 1e-6). The dense, masked, tombstone, ELL, postings, int8 (host
and device refine, one sweep and forced row blocks) and k-past-the-corpus
searches all run in one spawn of each world (`tests/torch_ranks.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.ops.fusion import rrf_fuse as j_rrf_fuse
from rag_dpo_tpu.parallel import MeshSpec as JMeshSpec
from rag_dpo_tpu.parallel import create_mesh as j_create_mesh
from test_sharded_hybrid import _build as j_build
from test_sharded_hybrid import _queries
from torch_ranks import run_ranks

DENSE_TOL, INT8_TOL, SPARSE_TOL = 2e-2, 1e-3, 1e-4


def _build(n=320, d=64, seed=0, mesh=None, ell=8, **cfg):
    """`test_sharded_hybrid._build` on the port's store."""
    from rag_dpo_tpu_torch.index import DeviceIndex, IndexConfig

    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, d)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    idx = DeviceIndex(IndexConfig(dim=d, ell_width=ell, row_block=64, **cfg),
                      device="cpu" if mesh is None else None, mesh=mesh)
    metas = [{"nature": ["DOCTRINE", "GUIDE", "SANCTION"][i % 3],
              "source": "CNIL" if i % 4 else "ENTERPRISE",
              "is_priority": i % 7 == 0} for i in range(n)]
    terms = rng.integers(0, 60, size=(n, ell)).astype(np.int32)
    impacts = np.abs(rng.standard_normal((n, ell))).astype(np.float32)
    idx.add([f"chunk_{i}" for i in range(n)], dense, metas, terms, impacts)
    return idx, dense


DEAD = [f"chunk_{i}" for i in (7, 8, 9, 100)]


def _cases(build):
    """Every case's (scores, ids) from one way of making a store (mesh or
    not)."""
    out = {}
    idx, dense = build()
    qt, qw = _queries()
    out["dense"] = idx.search_dense(dense[[7, 100, 255]], 10)
    out["masked"] = idx.search_dense(dense[[7, 100]], 10,
                                     where={"nature": "GUIDE"})
    out["ell"] = idx.search_sparse(qt, qw, 10)
    out["ell_masked"] = idx.search_sparse(qt, qw, 8,
                                          where={"source": "ENTERPRISE"})
    q2t, q2w = _queries(q=2)
    _, d_rows = idx.search_dense(dense[[17, 215]], 20)
    _, s_rows = idx.search_sparse(q2t, q2w, 20)
    out["rrf_rows"] = (d_rows, s_rows)
    idx.delete(DEAD)
    out["tombstones"] = idx.search_dense(dense[[7]], 5)
    out["postings"] = build(postings_threshold=16)[0].search_sparse(
        q2t, q2w, 5)
    q8 = dense[[3, 42, 311]]
    out["int8"] = build(quantize_int8=True)[0].search_dense(q8, 10)
    out["int8_masked"] = build(quantize_int8=True)[0].search_dense(
        q8[:2], 10, where={"is_priority": True})
    out["int8_refine"] = build(quantize_int8=True, device_refine=True)[
        0].search_dense(q8, 10)
    out["int8_blocks"] = build(quantize_int8=True, device_refine=True,
                               sweep_block_rows=32)[0].search_dense(q8, 10)
    small, sd = build(n=24)
    out["k_past_rows"] = small.search_dense(sd[[0]], 40)
    return out


def _rank_cases(rank, world):
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh

    mesh = create_mesh(MeshSpec(shard=world), device_type="cpu")
    return _cases(lambda **kw: _build(mesh=mesh, **kw))


@pytest.fixture(scope="module")
def port_single():
    torch.set_num_threads(2)
    return _cases(_build)


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"{w}ranks")
def ranks(request):
    return request.param, run_ranks(_rank_cases, request.param)


@pytest.fixture(scope="module")
def jax_results(eight_devices):
    """JAX's single-device oracle (exact dense, as its test takes it) and
    its 8-device mesh, case by case."""
    mesh = j_create_mesh(JMeshSpec(shard=8))
    qt, qw = _queries()
    q2t, q2w = _queries(q=2)
    out = {"single": {}, "mesh": {}}
    for name, m in (("single", None), ("mesh", mesh)):
        r = out[name]
        idx, dense, _, _ = j_build(mesh=m)
        exact = dict(exact=True) if m is None else {}
        r["dense"] = idx.search_dense(dense[[7, 100, 255]], 10, **exact)
        r["masked"] = idx.search_dense(dense[[7, 100]], 10,
                                       where={"nature": "GUIDE"})
        r["ell"] = idx.search_sparse(qt, qw, 10)
        r["ell_masked"] = idx.search_sparse(qt, qw, 8,
                                            where={"source": "ENTERPRISE"})
        _, d_rows = idx.search_dense(dense[[17, 215]], 20)
        _, s_rows = idx.search_sparse(q2t, q2w, 20)
        r["rrf_rows"] = (d_rows, s_rows)
        idx.delete(DEAD)
        r["tombstones"] = idx.search_dense(dense[[7]], 5)
        post = j_build(mesh=m, postings_threshold=16 if m is not None
                       else 100_000)[0]
        r["postings"] = post.search_sparse(q2t, q2w, 5)
        q8 = dense[[3, 42, 311]]
        r["int8"] = j_build(mesh=m, quantize_int8=True)[0].search_dense(
            q8, 10)
        r["int8_masked"] = j_build(mesh=m, quantize_int8=True)[
            0].search_dense(q8[:2], 10, where={"is_priority": True})
        r["int8_refine"] = j_build(mesh=m, quantize_int8=True,
                                   device_refine=True)[0].search_dense(q8, 10)
        small, sd, _, _ = j_build(n=24, mesh=m)
        r["k_past_rows"] = small.search_dense(sd[[0]], 40)
    return out


def _assert_match(got, want, atol):
    (s_g, i_g), (s_w, i_w) = got, want
    s_g, i_g, s_w, i_w = map(np.asarray, (s_g, i_g, s_w, i_w))
    valid = i_w >= 0
    np.testing.assert_array_equal(i_g[valid], i_w[valid])
    np.testing.assert_allclose(s_g[valid], s_w[valid], atol=atol)
    np.testing.assert_array_equal(i_g < 0, i_w < 0)


CASES = {"dense": DENSE_TOL, "masked": DENSE_TOL, "tombstones": DENSE_TOL,
         "ell": SPARSE_TOL, "ell_masked": SPARSE_TOL,
         "postings": SPARSE_TOL, "int8": INT8_TOL, "int8_masked": INT8_TOL,
         "int8_refine": INT8_TOL, "k_past_rows": DENSE_TOL}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_store_matches_jax_single_and_mesh(case, ranks, jax_results,
                                                   port_single):
    world, res = ranks
    for out in res:
        _assert_match(out[case], res[0][case], 0.0)     # same on every rank
        _assert_match(out[case], port_single[case], 1e-5)
        _assert_match(out[case], jax_results["single"][case], CASES[case])
        _assert_match(out[case], jax_results["mesh"][case], CASES[case])


def test_sharded_int8_blocks_equal_one_sweep(ranks):
    """device_refine's row-block scan on every shard gives the one-sweep
    ids (the blocks only bound the live score matrix)."""
    _, res = ranks
    for out in res:
        _assert_match(out["int8_blocks"], out["int8_refine"], 1e-6)


def test_sharded_guarantees_self_retrieval_filters_and_tombstones(ranks):
    _, res = ranks
    out = res[0]
    assert out["dense"][1][:, 0].tolist() == [7, 100, 255]
    assert out["int8"][1][:, 0].tolist() == [3, 42, 311]
    assert 7 not in out["tombstones"][1][0].tolist()
    rows = out["masked"][1]
    assert all(int(r) % 3 == 1 for r in rows[rows >= 0])       # GUIDE
    rows = out["int8_masked"][1]
    assert (rows >= 0).any() and all(int(r) % 7 == 0
                                     for r in rows[rows >= 0])
    rows = out["ell_masked"][1]
    assert all(int(r) % 4 == 0 for r in rows[rows >= 0])      # ENTERPRISE
    s, i = out["k_past_rows"]
    assert (i[0] >= 0).sum() == 24 and i[0][24:].tolist() == [-1] * 16


def test_sharded_hybrid_rrf_pipeline(ranks, jax_results):
    """Dense + sparse arms fused with RRF on the mesh: the single-device
    pipeline's fused ranking, in both packages."""
    from rag_dpo_tpu_torch.ops.fusion import rrf_fuse

    _, res = ranks
    w = np.asarray([2.0, 1.5], np.float32)
    jd, js = jax_results["single"]["rrf_rows"]
    jfs, jfr = j_rrf_fuse(jnp.asarray(np.stack([jd, js]), jnp.int32),
                          jnp.asarray(w), k_rrf=60, topk=10)
    for out in res:
        d, s = out["rrf_rows"]
        fs, fr = rrf_fuse(torch.from_numpy(np.stack([d, s]).astype(np.int32)),
                          torch.from_numpy(w), k_rrf=60, topk=10)
        np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr))
        np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), atol=1e-6)
