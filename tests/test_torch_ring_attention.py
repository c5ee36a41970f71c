"""The port's ring attention (`ops/ring_attention.py`) on 2 and 4 gloo
ranks and as logical shards of one process, against the JAX package's
plain attention and its 8-device ring (`tests/test_ring_attention.py`'s
cases, 2e-5; the encoder under `context_parallel`, 2e-4 as JAX's test).
A batch element of global length 0 gets JAX's value, the mean of every
value row. The K1 path's lse merge runs here over K1's plain twin
(`lse_merge=True`); bf16 inputs stay within 2e-2 of f32 (C-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models.encoder import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.models.encoder import TransformerEncoder as JEncoder
from rag_dpo_tpu.ops.flash_attention import attention_reference as j_ref
from rag_dpo_tpu.ops.ring_attention import make_ring_attention as j_ring
from rag_dpo_tpu.parallel import MeshSpec as JMeshSpec
from rag_dpo_tpu.parallel import create_mesh as j_create_mesh
from rag_dpo_tpu_torch.models.convert import load_flax_params
from rag_dpo_tpu_torch.models.encoder import EncoderConfig, TransformerEncoder
from rag_dpo_tpu_torch.ops.ring_attention import ring_attention_blocks
from torch_ranks import run_ranks

TOL = dict(atol=2e-5, rtol=2e-5)
ENC_TOL = dict(atol=2e-4, rtol=2e-4)
SHAPES = [(2, 2, 256, 32), (1, 4, 512, 64)]
RAGGED = [100, 32, 256]        # inside a shard, one whole shard, full
EMPTY = [0, 256]               # a batch element of length 0


def _qkv(b, h, s, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, dh)).astype(np.float32)
            for _ in range(3)]


def _enc_setup(seed, lengths):
    base = JEncoderConfig.tiny(use_flash_attention=False,
                               max_position_embeddings=130)
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, base.vocab_size, (2, 64)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    jmodel = JEncoder(base)
    params = jmodel.init(jax.random.key(0), jnp.asarray(ids),
                         jnp.asarray(lengths))
    ref = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                  jnp.asarray(lengths)))
    return jax.tree.map(np.asarray, params), ids, lengths, ref


def _port_encoder(params, impl):
    model = TransformerEncoder(EncoderConfig.tiny(
        use_flash_attention=False, max_position_embeddings=130,
        attention_impl=impl))
    tree = params["params"] if set(params) == {"params"} else params
    return load_flax_params(model, tree).eval()


def _rank_cases(rank, world, enc_inputs):
    from rag_dpo_tpu_torch.ops.ring_attention import make_ring_attention
    from rag_dpo_tpu_torch.parallel import (
        MeshSpec,
        context_parallel,
        create_mesh,
    )

    mesh = create_mesh(MeshSpec(shard=world), device_type="cpu")
    ring = make_ring_attention(mesh)
    t = torch.from_numpy
    out = {}
    for shape in SHAPES:
        out[shape] = ring(*map(t, _qkv(*shape, seed=shape[2]))).numpy()
    q, k, v = map(t, _qkv(3, 2, 256, 32, seed=11))
    out["ragged"] = ring(q, k, v, torch.tensor(RAGGED)).numpy()
    q, k, v = map(t, _qkv(2, 2, 256, 32, seed=12))
    out["empty"] = ring(q, k, v, torch.tensor(EMPTY)).numpy()
    for name, (params, ids, lengths) in enc_inputs.items():
        model = _port_encoder(params, "ring")
        with torch.no_grad(), context_parallel(mesh):
            out[name] = model(t(ids).long(), t(lengths)).numpy()
    return out


@pytest.fixture(scope="module")
def encoders():
    return {"enc_full": _enc_setup(7, [64, 64]),
            "enc_ragged": _enc_setup(13, [40, 64])}


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"{w}ranks")
def ranks(request, encoders):
    inputs = {k: v[:3] for k, v in encoders.items()}
    return run_ranks(_rank_cases, request.param, inputs)


@pytest.fixture(scope="module")
def jax_mesh(eight_devices):
    return j_create_mesh(JMeshSpec(shard=8))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ring_matches_reference_and_jax_ring(shape, ranks, jax_mesh):
    q, k, v = _qkv(*shape, seed=shape[2])
    ref = np.asarray(j_ref(*map(jnp.asarray, (q, k, v))))
    jring = np.asarray(j_ring(jax_mesh)(*map(jnp.asarray, (q, k, v))))
    for out in ranks:
        np.testing.assert_allclose(out[shape], ref, **TOL)
        np.testing.assert_allclose(out[shape], jring, **TOL)


def test_ring_ragged_lengths_match_reference(ranks):
    q, k, v = _qkv(3, 2, 256, 32, seed=11)
    ref = np.asarray(j_ref(*map(jnp.asarray, (q, k, v)),
                           jnp.asarray(RAGGED)))
    for out in ranks:
        assert np.isfinite(out["ragged"]).all()
        for i, n in enumerate(RAGGED):
            np.testing.assert_allclose(out["ragged"][i, :, :n],
                                       ref[i, :, :n], **TOL)


def test_length_zero_row_takes_jax_value(ranks, jax_mesh):
    q, k, v = _qkv(2, 2, 256, 32, seed=12)
    want = np.asarray(j_ring(jax_mesh)(*map(jnp.asarray, (q, k, v)),
                                       jnp.asarray(EMPTY)))
    np.testing.assert_allclose(want[0], np.broadcast_to(
        v[0].mean(axis=1, keepdims=True), want[0].shape), atol=1e-5)
    for out in ranks:
        np.testing.assert_allclose(out["empty"], want, **TOL)


@pytest.mark.parametrize("name", ["enc_full", "enc_ragged"])
def test_encoder_context_parallel_matches_single_chip(name, ranks,
                                                      encoders):
    _, _, lengths, ref = encoders[name]
    for out in ranks:
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(out[name][i, :n], ref[i, :n],
                                       **ENC_TOL)


def test_encoder_ring_without_scope_raises():
    model = TransformerEncoder(EncoderConfig.tiny(
        use_flash_attention=False, max_position_embeddings=130,
        attention_impl="ring"))
    with pytest.raises(RuntimeError, match="context_parallel"):
        model(torch.zeros((1, 64), dtype=torch.long),
              torch.tensor([64]))


@pytest.mark.parametrize("lse_merge", [False, True],
                         ids=["online-softmax", "lse-merge"])
@pytest.mark.parametrize("lengths", [None, RAGGED, [0, 100, 256]],
                         ids=["full", "ragged", "empty"])
def test_logical_shards_match_jax_ring(lengths, lse_merge, jax_mesh):
    """8 logical shards in one process (the smoke's form on one card), by
    JAX's online softmax and by the K1 path's lse merge (its plain twin
    here), against JAX's 8-device ring."""
    q, k, v = _qkv(3, 2, 256, 32, seed=5)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = np.asarray(j_ring(jax_mesh)(
        *map(jnp.asarray, (q, k, v)),
        None if lens is None else jnp.asarray(lens)))
    got = ring_attention_blocks(
        *map(torch.from_numpy, (q, k, v)),
        None if lens is None else torch.from_numpy(lens), 8,
        lse_merge=lse_merge).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_blocks_within_bf16_of_f32():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 256, 32, seed=9))
    lens = torch.tensor([200])
    f32 = ring_attention_blocks(q, k, v, lens, 4, lse_merge=True)
    for merge in (False, True):
        b16 = ring_attention_blocks(
            *(x.to(torch.bfloat16) for x in (q, k, v)), lens, 4,
            lse_merge=merge)
        assert b16.dtype == torch.bfloat16
        np.testing.assert_allclose(b16.float().numpy(), f32.numpy(),
                                   atol=2e-2, rtol=0)
