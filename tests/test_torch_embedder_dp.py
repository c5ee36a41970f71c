"""The port's data-parallel encode (`Embedder(..., mesh=)`) on 2 and 4 gloo
ranks against the JAX package's single-device embedder and the port's
(`tests/test_embedder_dp.py`'s case, 1e-5): `embed` (dense, sparse and
ColBERT), `embed_queries` and `embed_query`, the batch bucket rounded up
to the data axis, and the indexer's mesh passed to its index.
"""

import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.models.convert import state_dict_to_flax
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
from torch_ranks import run_ranks

TOL = dict(atol=1e-5, rtol=1e-5)
TEXTS = [f"document numéro {i} sur la protection des données "
         f"personnelles et la conformité" for i in range(11)]
QUERIES = ["violation de données", "registre des traitements"]


def _cfg():
    return EmbedderConfig(model=BgeM3Config(encoder=EncoderConfig.tiny(
        use_flash_attention=False), colbert_dim=32), batch_size=16)


def _encode(emb):
    full = emb.embed(TEXTS, return_sparse=True, return_colbert=True)
    return {"dense": full["dense"], "sparse": full["sparse"],
            "colbert": full["colbert"],
            "queries": emb.embed_queries(QUERIES),
            "query": emb.embed_query(QUERIES[0])}


def _rank_cases(rank, world, params):
    from rag_dpo_tpu_torch.ingest.indexer import CorpusIndexer
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh

    mesh = create_mesh(MeshSpec(data=world), device_type="cpu")
    emb = Embedder(_cfg(), params=params, mesh=mesh)
    out = _encode(emb)
    out["buckets"] = [emb._batch_bucket(b) for b in (1, 3, 8, 11)]
    index_mesh = create_mesh(MeshSpec(shard=world), device_type="cpu")
    indexer = CorpusIndexer(Embedder(_cfg(), params=params, device="cpu"),
                            ell_width=8, mesh=index_mesh)
    chunks = [{"chunk_id": f"c{i}", "text": t} for i, t in enumerate(TEXTS)]
    index, _, _ = indexer.build(chunks)
    out["index_shards"] = (index.mesh is index_mesh,
                           index.device_image()["embs"].shape[0])
    out["index_hit"] = index.search_dense(out["dense"][[4]], 3)[1]
    return out


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(2)
    emb = Embedder(_cfg(), device="cpu")
    return state_dict_to_flax(emb.load()), _encode(emb)


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"{w}ranks")
def ranks(request, single):
    return request.param, run_ranks(_rank_cases, request.param, single[0])


def test_dp_encode_matches_single_device(ranks, single):
    world, res = ranks
    _, want = single
    jemb = JEmbedder(JEmbedderConfig(model=JBgeM3Config(
        encoder=JEncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32), batch_size=16), params={"params": single[0]})
    jdense = jemb.embed(TEXTS)["dense"]
    np.testing.assert_allclose(want["dense"], jdense, **TOL)
    for out in res:
        np.testing.assert_allclose(out["dense"], want["dense"], **TOL)
        np.testing.assert_allclose(out["dense"], jdense, **TOL)
        np.testing.assert_allclose(out["queries"], want["queries"], **TOL)
        np.testing.assert_allclose(out["queries"],
                                   jemb.embed_queries(QUERIES), **TOL)
        np.testing.assert_allclose(out["query"], want["query"], **TOL)
        for a, b in zip(out["colbert"], want["colbert"]):
            np.testing.assert_allclose(a, b, **TOL)
        for a, b in zip(out["sparse"], want["sparse"]):
            assert a.keys() == b.keys()
            np.testing.assert_allclose(list(a.values()), list(b.values()),
                                       **TOL)


def test_batch_bucket_rounds_up_to_the_data_axis(ranks):
    world, res = ranks
    want = [-(-b // world) * world for b in (1, 8, 8, 64)]
    for out in res:
        assert out["buckets"] == want


def test_indexer_passes_its_mesh_to_the_index(ranks):
    world, res = ranks
    for out in res:
        is_mesh, rows = out["index_shards"]
        assert is_mesh and rows == 1024      # this rank's block of n_pad
        assert out["index_hit"][0, 0] == 4
