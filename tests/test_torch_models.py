"""Parity of the port's encoders with the Flax models of the JAX package.

Parameters come from the Flax initialiser (or the committed trained npz)
as numpy and are loaded into both packages; the inputs are made from a
seed. The JAX side runs its flash path in Pallas interpret mode.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import BgeM3Model as JBgeM3Model
from rag_dpo_tpu.models import CrossEncoderModel as JCrossEncoderModel
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.models.convert import load_params_npz as j_load_params_npz
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu_torch.models import BgeM3Config, BgeM3Model, CrossEncoderModel
from rag_dpo_tpu_torch.models import EncoderConfig
from rag_dpo_tpu_torch.models.convert import (
    flax_to_state_dict,
    load_flax_params,
    load_params_npz,
)
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig

torch.backends.cuda.matmul.allow_tf32 = False

TRAINED = (pathlib.Path(__file__).resolve().parent.parent / "rag_dpo_tpu"
           / "evals" / "data" / "trained_encoder_v2.npz")
# two f32 post-LN layers: the frameworks sum the matmuls and LayerNorm
# statistics in different orders, which leaves ~1e-6 on unit-scale values
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(seed, lengths, s, vocab=1024, pad=1):
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), s), pad, np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(4, vocab, size=n)
        ids[i, 0], ids[i, n - 1] = 0, 2
    return ids, np.asarray(lengths, np.int32)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("flash", [True, False])
def test_bge_m3_heads_match_flax(flash):
    jcfg = JBgeM3Config(encoder=JEncoderConfig.tiny(use_flash_attention=flash),
                        colbert_dim=32)
    ids, lengths = _ids(0, [40, 17, 5], 40)
    jmodel = JBgeM3Model(jcfg)
    params = jmodel.init(jax.random.key(3), jnp.asarray(ids))
    jout = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(lengths))

    model = BgeM3Model(BgeM3Config(
        encoder=EncoderConfig.tiny(use_flash_attention=flash),
        colbert_dim=32))
    load_flax_params(model, _numpy_tree(params))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.dense.numpy(), np.asarray(jout.dense),
                               **TOL)
    np.testing.assert_allclose(out.sparse.numpy(), np.asarray(jout.sparse),
                               **TOL)
    np.testing.assert_allclose(out.colbert.numpy(), np.asarray(jout.colbert),
                               **TOL)
    assert (out.sparse.numpy()[2, 5:] == 0).all()


def test_cross_encoder_matches_flax():
    jcfg = JEncoderConfig.tiny()
    ids, lengths = _ids(1, [64, 30, 12, 1], 64)
    jmodel = JCrossEncoderModel(jcfg)
    params = jmodel.init(jax.random.key(1), jnp.asarray(ids))
    jscores = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(lengths))
    model = CrossEncoderModel(EncoderConfig.tiny())
    load_flax_params(model, _numpy_tree(params))
    with torch.no_grad():
        scores = model(torch.from_numpy(ids).long(),
                       torch.from_numpy(lengths))
    assert scores.shape == (4,)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **TOL)


def test_flax_tree_mapping_is_strict():
    model = CrossEncoderModel(EncoderConfig.tiny(num_layers=1))
    tree = {"params": {"classifier": {"kernel": np.zeros((64, 1)),
                                      "bias": np.zeros((1,))}}}
    with pytest.raises(KeyError):
        load_flax_params(model, tree)
    names = flax_to_state_dict({"encoder": {"layer_0": {"attention": {
        "query": {"kernel": np.zeros((2, 3))}}},
        "embeddings_norm": {"scale": np.ones(2)}}})
    assert names["encoder.layer_0.attention.query.weight"].shape == (3, 2)
    assert "encoder.embeddings_norm.weight" in names


def test_trained_npz_gives_same_dense_vectors_in_both_packages():
    texts = ["Qu'est-ce qu'un responsable de traitement ?",
             "La durée de conservation des données doit être limitée.",
             "Sous-traitant : obligations de l'article 28 du RGPD."]
    jemb = JEmbedder(
        JEmbedderConfig(model=JBgeM3Config(
            encoder=JEncoderConfig.tiny(use_flash_attention=False),
            colbert_dim=32)),
        params=j_load_params_npz(TRAINED))
    emb = Embedder(
        EmbedderConfig(model=BgeM3Config(
            encoder=EncoderConfig.tiny(use_flash_attention=False),
            colbert_dim=32)),
        params=load_params_npz(TRAINED), device="cpu")
    assert len(np.load(TRAINED).files) == 41
    np.testing.assert_allclose(emb.embed(texts)["dense"],
                               jemb.embed(texts)["dense"], **TOL)
    np.testing.assert_allclose(emb.embed_queries(texts[:1]),
                               jemb.embed_queries(texts[:1]), **TOL)
    sp, jsp = (e.embed(texts, return_sparse=True)["sparse"]
               for e in (emb, jemb))
    for a, b in zip(sp, jsp):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(list(a.values()), list(b.values()), **TOL)


def test_random_init_is_seeded_and_unit_norm():
    cfg = EmbedderConfig(model=BgeM3Config.tiny())
    a = Embedder(cfg, rng_seed=7, device="cpu").embed(["un texte"])["dense"]
    b = Embedder(cfg, rng_seed=7, device="cpu").embed(["un texte"])["dense"]
    c = Embedder(cfg, rng_seed=8, device="cpu").embed(["un texte"])["dense"]
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, rtol=1e-5)


def test_build_bge_m3_runs_on_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    """`build_bge_m3` resolves `device=None` as every entry point of the
    port does: the card, and without one the error `default_device`
    raises; the CPU only where the caller asks for it."""
    from rag_dpo_tpu_torch.models.bge_m3 import build_bge_m3
    from rag_dpo_tpu_torch.ops import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        default_device(None)
    with pytest.raises(RuntimeError) as got:
        build_bge_m3(BgeM3Config.tiny())
    assert str(got.value) == str(want.value)
    model = build_bge_m3(BgeM3Config.tiny(), rng_seed=3, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
