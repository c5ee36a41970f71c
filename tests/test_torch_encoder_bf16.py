"""`EncoderConfig.dtype=torch.bfloat16` against JAX's own bf16 forward.

The same Flax parameters (f32, as Flax keeps them) go into both packages;
each casts them to bf16 for every product and lookup and keeps LayerNorm
statistics in f32. The two frameworks round the bf16 products and sums at
different points (XLA rounds each product's output, then adds the bias in
bf16; torch adds the bias before its one rounding), so outputs agree to a
few bf16 ulps: `BF16_TOL` (2e-2 absolute, C-5's bf16 flash tolerance, on
unit-scale values). The f32 default is unchanged (`tests/test_torch_models.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import BgeM3Model as JBgeM3Model
from rag_dpo_tpu.models import CrossEncoderModel as JCrossEncoderModel
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu_torch.models import (
    BgeM3Config,
    BgeM3Model,
    CrossEncoderModel,
    EncoderConfig,
)
from rag_dpo_tpu_torch.models.convert import load_flax_params
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig
from rag_dpo_tpu_torch.train.contrastive import (
    contrastive_loss,
    create_train_state,
)
from test_torch_models import _ids, _numpy_tree
from test_torch_train import _batch, _cfg, _jax_loss_fn, _jax_params, _to_jax
from test_torch_train import _to_torch

BF16_TOL = dict(atol=2e-2, rtol=0)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("flash", [True, False])
def test_bf16_bge_m3_dense_sparse_colbert_match_jax(flash):
    jcfg = JBgeM3Config(encoder=JEncoderConfig.tiny(
        use_flash_attention=flash, dtype=jnp.bfloat16), colbert_dim=32)
    ids, lengths = _ids(0, [40, 17, 5], 40)
    jmodel = JBgeM3Model(jcfg)
    params = jmodel.init(jax.random.key(3), jnp.asarray(ids))
    jout = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(lengths))

    model = BgeM3Model(BgeM3Config(encoder=EncoderConfig.tiny(
        use_flash_attention=flash, dtype=torch.bfloat16), colbert_dim=32))
    load_flax_params(model, _numpy_tree(params))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(lengths))
    assert out.dense.dtype == torch.bfloat16
    assert out.colbert.dtype == torch.bfloat16
    assert out.sparse.dtype == torch.float32
    for got, want in ((out.dense, jout.dense), (out.sparse, jout.sparse),
                      (out.colbert, jout.colbert)):
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **BF16_TOL)
    # and the bf16 run is not the f32 one: the mode really changed
    model32 = BgeM3Model(BgeM3Config(encoder=EncoderConfig.tiny(
        use_flash_attention=flash), colbert_dim=32))
    load_flax_params(model32, _numpy_tree(params))
    with torch.no_grad():
        out32 = model32(torch.from_numpy(ids).long(),
                        torch.from_numpy(lengths))
    assert not torch.equal(out32.dense, out.dense.float())


def test_bf16_cross_encoder_matches_jax():
    jcfg = JEncoderConfig.tiny(dtype=jnp.bfloat16)
    ids, lengths = _ids(1, [30, 12, 7, 30], 30)
    jmodel = JCrossEncoderModel(jcfg)
    params = jmodel.init(jax.random.key(4), jnp.asarray(ids))
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                   jnp.asarray(lengths)))
    model = CrossEncoderModel(EncoderConfig.tiny(dtype=torch.bfloat16))
    load_flax_params(model, _numpy_tree(params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)


def test_bf16_embedder_encodes_like_the_bf16_model():
    """The `Embedder` front door carries the mode: its vectors are the bf16
    model's, within bf16 of the f32 embedder's."""
    enc = EncoderConfig.tiny(use_flash_attention=False)
    cfg32 = EmbedderConfig(model=BgeM3Config(encoder=enc, colbert_dim=32),
                           batch_size=8)
    cfg16 = dataclasses.replace(cfg32, model=BgeM3Config(
        encoder=dataclasses.replace(enc, dtype=torch.bfloat16),
        colbert_dim=32))
    e32 = Embedder(cfg32, device="cpu")
    params = {k: v.detach().numpy() for k, v in
              e32.load().state_dict().items()}
    e16 = Embedder(cfg16, device="cpu")
    e16.load().load_state_dict({k: torch.from_numpy(v)
                                for k, v in params.items()})
    texts = [f"la donnée {i} du registre" for i in range(5)]
    d32, d16 = e32.embed(texts)["dense"], e16.embed(texts)["dense"]
    assert d16.dtype == np.float32
    np.testing.assert_allclose(d16, d32, **BF16_TOL)
    np.testing.assert_allclose(e16.embed_queries(texts[:2]), d16[:2],
                               atol=1e-6)


@pytest.mark.parametrize("negatives", [False, True],
                         ids=["in-batch", "hard-negatives"])
def test_bf16_train_step_loss_matches_jax(negatives):
    jcfg, cfg = _cfg(flash=True)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, encoder=dataclasses.replace(jcfg.model.encoder,
                                                dtype=jnp.bfloat16)))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=dataclasses.replace(cfg.model.encoder,
                                               dtype=torch.bfloat16)))
    params = _jax_params(jcfg)
    batch = _batch(3, negatives)
    j_loss, _ = _jax_loss_fn(jcfg)(params, _to_jax(batch))
    state = create_train_state(cfg, params=params, device="cpu")
    loss, _ = contrastive_loss(state.model, _to_torch(batch),
                               cfg.temperature)
    loss.backward()
    # the loss is a bf16 scalar near 1.7 (ulp 2^-7): relative 2e-2 is
    # under three ulps of it; each framework's bf16 cross-entropy rounds
    # its log-softmax and mean at its own points
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=2e-2)
    grads = [p.grad for p in state.model.encoder.parameters()
             if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_resident_bf16_casts_follow_the_parameters():
    """Outside a backward pass a bf16 Dense keeps its cast kernel; a load
    or an in-place edit of the f32 parameter makes it again."""
    from rag_dpo_tpu_torch.models.encoder import Dense

    torch.manual_seed(0)
    d = Dense(8, 4, torch.bfloat16)
    x = torch.randn(3, 8)
    with torch.no_grad():
        first = d(x)
        assert torch.equal(d(x), first)
        d.weight.mul_(2.0)
        again = d(x)
    want = (x.to(torch.bfloat16) @ (d.weight.to(torch.bfloat16)).T
            ).to(torch.bfloat16) + d.bias.to(torch.bfloat16)
    assert torch.equal(again, want)
    assert not torch.equal(again, first)
    # with gradients the cast is made per call and carries them back
    y = d(x).float().sum()
    y.backward()
    assert d.weight.grad is not None and d.weight.grad.dtype == torch.float32
