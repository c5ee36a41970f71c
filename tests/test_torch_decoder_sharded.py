"""The port's tensor-parallel decoder (`models/sharding.py`, the decoder's
TP slices) on 2 and 4 gloo ranks against the JAX package
(`tests/test_decoder_sharded.py`'s cases): the forward within 1e-4 of
JAX's single-device forward on the same JAX-exported weights, and greedy
generation with tokens equal to JAX's and to the port's unsharded run.
At 4 ranks the generation config's 2 KV heads do not split, so that case
runs the all-gather of q/k/v; the int8 KV cache and the int8 projections
(replicated, JAX's rule) run under TP too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu.models.decoder import DecoderModel as JDecoderModel
from rag_dpo_tpu.models.generate import SamplingConfig as JSamplingConfig
from rag_dpo_tpu.models.generate import TextGenerator as JTextGenerator
from rag_dpo_tpu.models.sharding import param_shardings as j_param_shardings
from rag_dpo_tpu.parallel import MeshSpec as JMeshSpec
from rag_dpo_tpu.parallel import create_mesh as j_create_mesh
from rag_dpo_tpu_torch.models.sharding import param_spec
from test_torch_decoder import jax_params, port_config
from torch_ranks import run_ranks

FWD_J = JDecoderConfig.tiny(num_heads=8, num_kv_heads=8, hidden_size=64,
                            dtype=jnp.float32)
GEN_J = JDecoderConfig.tiny(num_heads=4, num_kv_heads=2, dtype=jnp.float32)
IDS = np.random.default_rng(0).integers(3, 512, (2, 12)).astype(np.int32)
PROMPTS = np.random.default_rng(1).integers(3, 512, (2, 10)).astype(np.int32)
LENGTHS = np.asarray([10, 7], np.int32)
MAX_NEW = 5


def _generate(cfg, params, mesh=None):
    from rag_dpo_tpu_torch.models.generate import SamplingConfig, TextGenerator
    from rag_dpo_tpu_torch.models.sharding import shard_params

    tree = params if mesh is None else shard_params(params, mesh)
    gen = TextGenerator(cfg, params=tree, device="cpu")
    out = gen.generate_ids(PROMPTS, LENGTHS, SamplingConfig(
        temperature=0.0, max_new_tokens=MAX_NEW, eos_id=-1))
    return np.asarray(out), gen.load()


def _rank_cases(rank, world, fwd_params, gen_params, int8_params):
    from rag_dpo_tpu_torch.models.decoder import build_decoder
    from rag_dpo_tpu_torch.models.decoder import load_decoder_params
    from rag_dpo_tpu_torch.models.sharding import shard_params
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh

    mesh = create_mesh(MeshSpec(model=world), device_type="cpu")
    out = {}
    sharded = shard_params(fwd_params, mesh)
    model = load_decoder_params(
        build_decoder(port_config(FWD_J), "cpu", sharded.tp), sharded)
    out["q_shape"] = tuple(model.layer_0.attention.q_proj.weight.shape)
    out["cache_heads"] = model.cache_heads
    with torch.no_grad():
        out["forward"] = model(torch.from_numpy(IDS).long()).numpy()
    cfg = port_config(GEN_J)
    out["tokens"], gmodel = _generate(cfg, gen_params, mesh)
    out["gen_cache_heads"] = gmodel.cache_heads
    out["gather"] = gmodel.layer_0.attention.gather
    out["tokens_kv8"], _ = _generate(
        dataclasses.replace(cfg, quantize_kv=True), gen_params, mesh)
    out["tokens_int8"], _ = _generate(
        dataclasses.replace(cfg, quantize_weights=True), int8_params, mesh)
    return out


@pytest.fixture(scope="module")
def params():
    return (jax_params(FWD_J), jax_params(GEN_J),
            jax_params(dataclasses.replace(GEN_J, quantize_weights=True)))


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"{w}ranks")
def ranks(request, params):
    return request.param, run_ranks(_rank_cases, request.param, *params)


def test_tp_sharded_forward_matches_jax(ranks, params):
    world, res = ranks
    want = np.asarray(JDecoderModel(FWD_J).apply(params[0],
                                                 jnp.asarray(IDS)))
    for out in res:
        assert out["q_shape"] == (64 // world, 64)    # q_proj really split
        assert out["cache_heads"] == 8 // world
        np.testing.assert_allclose(out["forward"], want, atol=1e-4,
                                   rtol=1e-4)


def test_tp_sharded_generation_matches_jax_and_unsharded(ranks, params):
    world, res = ranks
    jgen = JTextGenerator(GEN_J, params=params[1])
    want = np.asarray(jgen.generate_ids(PROMPTS, LENGTHS, JSamplingConfig(
        temperature=0.0, max_new_tokens=MAX_NEW, eos_id=-1)))
    cfg = port_config(GEN_J)
    single, _ = _generate(cfg, params[1])
    kv8, _ = _generate(dataclasses.replace(cfg, quantize_kv=True), params[1])
    int8, _ = _generate(dataclasses.replace(cfg, quantize_weights=True),
                        params[2])
    np.testing.assert_array_equal(single, want)
    for out in res:
        assert out["gather"] == (2 % world != 0)
        assert out["gen_cache_heads"] == (1 if world == 2 else 2)
        np.testing.assert_array_equal(out["tokens"], want)
        np.testing.assert_array_equal(out["tokens_kv8"], kv8)
        np.testing.assert_array_equal(out["tokens_int8"], int8)


def test_param_specs_are_jax_rules(params, eight_devices):
    mesh = j_create_mesh(JMeshSpec(model=8, shard=1))
    jspecs = j_param_shardings(params[0], mesh)
    paths = jax.tree_util.tree_flatten_with_path(jspecs)[0]
    assert paths
    for path, sharding in paths:
        keys = tuple(p.key for p in path)
        want = tuple(sharding.spec)
        assert param_spec(keys) == want + (None,) * (len(param_spec(keys))
                                                     - len(want)), keys
    assert param_spec(("layer_0", "attention", "q_proj", "kernel_q")) == ()
