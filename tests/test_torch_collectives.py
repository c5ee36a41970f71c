"""The port's collectives (`parallel/collectives.py`) against the JAX
package's: the pure halves in one process (S logical shards stacked, as
the smoke runs them on one card), and `sharded_topk_multi` on 2 and 4 gloo
ranks against JAX's 8-device mesh. Ids equal, scores within 1e-6 (the
same f32 scores, selected)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.parallel import MeshSpec as JMeshSpec
from rag_dpo_tpu.parallel import create_mesh as j_create_mesh
from rag_dpo_tpu.parallel import shard_leading_axis as j_shard_leading_axis
from rag_dpo_tpu.parallel import sharded_topk_multi as j_sharded_topk_multi
from rag_dpo_tpu.parallel.collectives import (
    topk_merge_pairs as j_topk_merge_pairs,
)
from rag_dpo_tpu_torch.parallel.collectives import (
    local_topk,
    merge_topk,
    topk_merge_pairs,
)
from torch_ranks import run_ranks

N, D, Q = 96, 8, 3


def _data(seed=0):
    rng = np.random.default_rng(seed)
    embs = np.round(rng.standard_normal((N, D)), 1).astype(np.float32)
    qs = np.round(rng.standard_normal((Q, D)), 1).astype(np.float32)
    embs[40] = embs[7]          # exact ties across shards
    embs[90] = embs[7]
    rep = rng.standard_normal((D,)).astype(np.float32)  # replicated operand
    return embs, qs, rep


def _local_fn_np(k):
    def fn(qs, shard_embs, rep):
        return qs @ (shard_embs * rep[None, :]).T, k
    return fn


def _jax_search(k, kk, n_dev=8):
    """JAX's `sharded_topk_multi` with a local top-kk (pad or cut path)."""
    mesh = j_create_mesh(JMeshSpec(shard=n_dev))

    def local_fn(qs, shard_embs, rep):
        s = qs @ (shard_embs * rep[None, :]).T
        return jax.lax.top_k(s, min(kk, s.shape[1]))

    embs, qs, rep = _data()
    sh = j_shard_leading_axis(mesh)
    search = j_sharded_topk_multi(mesh, local_fn, k, n_sharded=1,
                                  n_replicated=1)
    s, i = search(jnp.asarray(qs),
                  jax.device_put(jnp.arange(N, dtype=jnp.int32), sh),
                  jax.device_put(jnp.asarray(embs), sh), jnp.asarray(rep))
    return np.asarray(s), np.asarray(i)


def _port_local(qs, shard_embs, rep, kk):
    s = qs @ (shard_embs * rep[None, :]).T
    from rag_dpo_tpu_torch.ops.quantize import _stable_topk
    return _stable_topk(s, min(kk, s.shape[1]))


@pytest.mark.parametrize("k,kk", [(5, 5), (5, 2), (5, 20), (15, 15)],
                         ids=["equal", "pad", "cut", "k-past-shard"])
def test_stacked_logical_shards_match_jax_mesh(k, kk, eight_devices):
    """8 logical shards in one process: each shard's local half, stacked
    [Q, 8, k], then the merge — JAX's 8-device program, tie order too."""
    embs, qs, rep = _data()
    t = torch.from_numpy
    per = N // 8
    halves = [local_topk(*_port_local(t(qs), t(embs[j * per:(j + 1) * per]),
                                      t(rep), kk), k,
                         torch.arange(j * per, (j + 1) * per,
                                      dtype=torch.int32))
              for j in range(8)]
    s, i = merge_topk(torch.stack([h[0] for h in halves], 1),
                      torch.stack([h[1] for h in halves], 1), k)
    js, ji = _jax_search(k, kk)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=1e-6)


def test_merge_takes_the_lowest_flat_index_among_ties():
    scores = np.asarray([[[3, 1, 1], [3, 2, 1]]], np.float32)   # [1, 2, 3]
    ids = np.asarray([[[10, 11, 12], [20, 21, 22]]], np.int32)
    s, i = merge_topk(torch.from_numpy(scores), torch.from_numpy(ids), 5)
    top, pos = jax.lax.top_k(jnp.asarray(scores.reshape(1, -1)), 5)
    np.testing.assert_array_equal(i.numpy(),
                                  ids.reshape(1, -1)[0][np.asarray(pos)])
    assert i.numpy().tolist() == [[10, 20, 21, 11, 12]]


def test_topk_merge_pairs_matches_jax():
    rng = np.random.default_rng(4)
    sa = np.sort(np.round(rng.standard_normal((3, 6)), 1), 1)[:, ::-1]
    sb = np.sort(np.round(rng.standard_normal((3, 4)), 1), 1)[:, ::-1]
    sa, sb = sa.astype(np.float32).copy(), sb.astype(np.float32).copy()
    ia = rng.integers(0, 100, (3, 6)).astype(np.int32)
    ib = rng.integers(100, 200, (3, 4)).astype(np.int32)
    js, ji = j_topk_merge_pairs(*(jnp.asarray(x) for x in (sa, ia, sb, ib)),
                                k=7)
    s, i = topk_merge_pairs(*(torch.from_numpy(x) for x in (sa, ia, sb, ib)),
                            k=7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _rank_cases(rank, world):
    from rag_dpo_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
        shard_leading_axis,
        sharded_topk_multi,
    )

    mesh = create_mesh(MeshSpec(shard=world), device_type="cpu")
    embs, qs, rep = _data()
    out = {}
    for k, kk in ((5, 5), (5, 2), (5, 40), (15, 15)):
        search = sharded_topk_multi(
            mesh, lambda q, e, r, kk=kk: _port_local(q, e, r, kk), k,
            n_sharded=1, n_replicated=1)
        s, i = search(torch.from_numpy(qs),
                      shard_leading_axis(mesh, np.arange(N,
                                                         dtype=np.int32)),
                      shard_leading_axis(mesh, embs), torch.from_numpy(rep))
        out[(k, kk)] = (s.numpy(), i.numpy())
    return out


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"{w}ranks")
def ranks(request):
    return run_ranks(_rank_cases, request.param)


def test_sharded_topk_multi_on_ranks_matches_jax(ranks, eight_devices):
    """Across 2 and 4 ranks the merged ids are the exact global top-k,
    the same on every rank, and JAX's where its local lists hold it."""
    embs, qs, rep = _data()
    full = qs @ (embs * rep[None, :]).T
    for (k, kk), _ in ranks[0].items():
        want = np.argsort(-full, axis=1, kind="stable")[:, :k]
        for out in ranks:
            s, i = out[(k, kk)]
            np.testing.assert_array_equal(i, ranks[0][(k, kk)][1])
            if kk >= k:   # every shard's list holds its part of the top-k
                np.testing.assert_array_equal(i, want)
                np.testing.assert_allclose(
                    s, np.take_along_axis(full, want, 1), atol=1e-5)
                np.testing.assert_array_equal(i, _jax_search(k, kk)[1])
