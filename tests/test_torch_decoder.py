"""The port's decoder (slice 16) against the JAX package's, on the CPU.

Weights come from the JAX module's own init (Flax threefry), exported as
numpy and loaded into the port (`models.decoder.load_decoder_params`); the
same numpy ids go through both. Tolerances:

* f32: logits within `F32_TOL` = 1e-4 (measured ≤ 3e-6 on logits of
  magnitude ~4: only the order of f32 sums differs);
* bf16 activations, f32 or int8 weights: within `BF16_TOL` = 0.1, three
  bf16 ulps at the logits' magnitude (~4, where an ulp is 2^-5): both
  packages round ~30 intermediate activations to bf16 a layer, each in its
  own order (measured ≤ 0.043), and at least 90% of the argmaxes agree;
* greedy ids at f32: equal;
* the tied head computes in the module dtype, as Flax's `Embed.attend`
  promotes its operands to it: bf16 logits at bf16.

The cache paths are held to a full forward (the KV cache, padded
prefill), to JAX's caches (the dynamic_update_slice clamp, the int8
cache's values), and to themselves (int8 requantization is stable). HF
`LlamaForCausalLM` / `MistralForCausalLM` with random init (this container
only) go through `convert_llama_state_dict` into the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu.models.decoder import DecoderModel as JDecoderModel
from rag_dpo_tpu.models.decoder import rope as jrope
from rag_dpo_tpu.models.decoder import (
    quantize_decoder_params as jquantize,
)
from rag_dpo_tpu.models.generate import SamplingConfig as JSamplingConfig
from rag_dpo_tpu.models.generate import TextGenerator as JTextGenerator
from rag_dpo_tpu_torch.models.convert import convert_llama_state_dict
from rag_dpo_tpu_torch.models.decoder import (
    DecoderConfig,
    DecoderModel,
    QuantDense,
    RMSNorm,
    build_decoder,
    init_random_,
    load_decoder_params,
    quantize_decoder_params,
    rope,
    rope_tables,
)
from rag_dpo_tpu_torch.models.generate import SamplingConfig, TextGenerator

F32_TOL = 1e-4
BF16_TOL = 0.1
TORCH_DTYPE = {jnp.dtype(jnp.float32): torch.float32,
               jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_config(jcfg: JDecoderConfig) -> DecoderConfig:
    """The port's config of a JAX `DecoderConfig` (dtypes mapped)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dtype"] = TORCH_DTYPE[jnp.dtype(kw["dtype"])]
    kw["param_dtype"] = TORCH_DTYPE[jnp.dtype(kw["param_dtype"])]
    return DecoderConfig(**kw)


def jax_params(jcfg: JDecoderConfig, seed: int = 0) -> dict:
    """The JAX module's init as numpy ({'params': ...}); int8 configs get
    the float init quantized by the JAX package."""
    fcfg = dataclasses.replace(jcfg, quantize_weights=False)
    params = JDecoderModel(fcfg).init(jax.random.key(seed),
                                      jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    if jcfg.quantize_weights:
        params = {"params": jquantize(params["params"])}
    return params


def port_model(jcfg, params) -> DecoderModel:
    return load_decoder_params(build_decoder(port_config(jcfg), "cpu"),
                               params)


def jax_logits(jcfg, params, ids) -> np.ndarray:
    out = JDecoderModel(jcfg).apply(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(ids, jnp.int32))
    return np.asarray(out)


def _ids(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(3, vocab, shape
                                                ).astype(np.int32)


CONFIGS = {
    "f32": dict(dtype=jnp.float32),
    "f32_tied": dict(dtype=jnp.float32, tie_embeddings=True),
    "f32_int8": dict(dtype=jnp.float32, quantize_weights=True),
    "bf16": dict(),
    "bf16_tied": dict(tie_embeddings=True),
    "bf16_params": dict(param_dtype=jnp.bfloat16),
    "bf16_int8_tied": dict(quantize_weights=True, tie_embeddings=True),
    "bf16_int8_head": dict(quantize_weights=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_jax(name):
    jcfg = JDecoderConfig.tiny(**CONFIGS[name])
    params = jax_params(jcfg)
    ids = _ids(0, (2, 16))
    want = jax_logits(jcfg, params, ids)
    with torch.no_grad():
        got = port_model(jcfg, params)(torch.as_tensor(ids, dtype=torch.long))
    assert got.shape == want.shape == (2, 16, 512)
    # the tied head in the module dtype, the untied one in f32
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got = got.float().numpy()
    want = want.astype(np.float32)
    tol = F32_TOL if jcfg.dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if jcfg.dtype == jnp.float32:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    want = np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = rope(torch.from_numpy(x),
               rope_tables(torch.from_numpy(pos).long(), 16, 1e6))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    from rag_dpo_tpu.models.decoder import RMSNorm as JRMSNorm

    h = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(JRMSNorm(1e-5).apply({"params": {"scale": scale}},
                                           jnp.asarray(h)))
    norm = RMSNorm(16, 1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_quantize_decoder_params_is_the_jax_packages():
    jcfg = JDecoderConfig.tiny(dtype=jnp.float32)
    tree = jax_params(jcfg)["params"]
    want = jax.tree.map(np.asarray, jquantize(tree))
    got = quantize_decoder_params(tree)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), path


def test_greedy_ids_equal_jax_at_f32():
    jcfg = JDecoderConfig.tiny(dtype=jnp.float32)
    params = jax_params(jcfg)
    ids = _ids(3, (2, 10))
    lengths = np.asarray([10, 6], np.int32)
    want = JTextGenerator(jcfg, params=jax.tree.map(jnp.asarray, params)
                          ).generate_ids(ids, lengths, JSamplingConfig(
                              temperature=0.0, max_new_tokens=12,
                              eos_id=-1))
    got = TextGenerator(port_config(jcfg), params=params, device="cpu"
                        ).generate_ids(ids, lengths, SamplingConfig(
                            temperature=0.0, max_new_tokens=12, eos_id=-1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,tol", [(dict(dtype=torch.float32), 1e-5),
                                    (dict(), 2e-2),
                                    (dict(dtype=torch.float32,
                                          quantize_kv=True), 1e-5)])
def test_kv_cache_matches_full_forward(kw, tol):
    """prefill + step-by-step decode == the full causal forward (the
    int8 cache against a full forward over the same cache)."""
    cfg = DecoderConfig.tiny(**kw)
    model = init_random_(build_decoder(cfg, "cpu"), 0)
    ids = torch.as_tensor(_ids(1, (2, 10)), dtype=torch.long)
    b, s, pre = 2, 10, 6
    with torch.no_grad():
        caches = DecoderModel.init_cache(cfg, b)
        positions = torch.arange(s).expand(b, s)
        if cfg.quantize_kv:
            # the reference is the forward over the whole prompt through a
            # fresh int8 cache: each query attends the same dequantized K/V
            full, _ = model(ids, positions, DecoderModel.init_cache(cfg, b))
        else:
            full = model(ids)
        logits, caches = model(ids[:, :pre], positions[:, :pre], caches,
                               write_mask=torch.ones(b, pre, dtype=bool),
                               kv_len=pre)
        np.testing.assert_allclose(logits.float().numpy(),
                                   full[:, :pre].float().numpy(),
                                   atol=tol, rtol=tol)
        for t in range(pre, s):
            step, caches = model(ids[:, t:t + 1], positions[:, t:t + 1],
                                 caches, kv_len=t + 1)
            np.testing.assert_allclose(step[:, 0].float().numpy(),
                                       full[:, t].float().numpy(),
                                       atol=tol, rtol=tol)


def test_padded_prefill_does_not_pollute():
    """Rows with shorter prompts: pad tokens must not affect decoding."""
    gen = TextGenerator(DecoderConfig.tiny(), device="cpu")
    rng = np.random.default_rng(2)
    prompt = rng.integers(3, 512, (1, 5)).astype(np.int32)
    sampling = SamplingConfig(temperature=0.0, max_new_tokens=4, eos_id=-1)
    out_a = gen.generate_ids(prompt, np.asarray([5]), sampling)
    padded = np.concatenate(
        [prompt, rng.integers(3, 512, (1, 7)).astype(np.int32)], axis=1)
    out_b = gen.generate_ids(padded, np.asarray([5]), sampling)
    np.testing.assert_array_equal(out_a, out_b)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_cache_write_clamps_like_dynamic_update_slice(quantize_kv):
    """A window past the cache's end lands at max_len - S, as
    `lax.dynamic_update_slice` puts it, with the padding rows zeroed:
    the caches and logits equal JAX's."""
    jcfg = JDecoderConfig.tiny(dtype=jnp.float32, quantize_kv=quantize_kv)
    params = jax_params(jcfg)
    ids = _ids(4, (2, 4))
    pos = np.asarray([[6, 7, 8, 9], [2, 3, 4, 5]], np.int32)
    wmask = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    jcaches = JDecoderModel.init_cache(jcfg, 2, length=8)
    jl, jc = JDecoderModel(jcfg).apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
        jnp.asarray(pos), jcaches, write_mask=jnp.asarray(wmask))
    cfg = port_config(jcfg)
    model = port_model(jcfg, params)
    caches = DecoderModel.init_cache(cfg, 2, length=8)
    with torch.no_grad():
        tl, tc = model(torch.as_tensor(ids, dtype=torch.long),
                       torch.as_tensor(pos, dtype=torch.long), caches,
                       write_mask=torch.as_tensor(wmask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32_TOL)
    for layer_j, layer_t in zip(jc, tc):
        assert sorted(layer_j) == sorted(layer_t)
        for name, value in layer_j.items():
            want = np.asarray(value).astype(np.float32)
            got = layer_t[name].float().numpy()
            # where JAX wrote, the port wrote (rows 4..7 of row 0, clamped)
            np.testing.assert_array_equal(got != 0, want != 0, err_msg=name)
            if name in ("k", "v") and quantize_kv:
                # int8 values: a rounding boundary may fall either way
                assert np.abs(got - want).max() <= 1, name
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                           err_msg=name)


def test_int8_kv_requantization_is_stable():
    """Dequantize a written int8 cache row and write it again: the int8
    values come back bit for bit (scale = rowmax/127 puts the max at
    ±127), so decode steps never drift the cache."""
    cfg = DecoderConfig.tiny(dtype=torch.float32, quantize_kv=True)
    model = init_random_(build_decoder(cfg, "cpu"), 5)
    ids = torch.as_tensor(_ids(5, (2, 12)), dtype=torch.long)
    with torch.no_grad():
        caches = DecoderModel.init_cache(cfg, 2)
        model(ids, torch.arange(12).expand(2, 12), caches)
        for layer in caches:
            for name in ("k", "v"):
                deq = layer[name][:, :12].float() \
                    * layer[name + "_scale"][:, :12, :, None]
                scale = deq.abs().amax(-1) / 127.0
                safe = torch.where(scale > 0, scale, 1.0)
                again = torch.clamp(torch.round(deq / safe[..., None]),
                                    -127, 127).to(torch.int8)
                assert torch.equal(again, layer[name][:, :12])
                assert layer[name].dtype == torch.int8
                assert layer[name + "_scale"].dtype == torch.float32


def test_quantized_structure_matches_the_jax_tree():
    """Every leaf of a quantized JAX tree has a place in the port's int8
    module, int8 kernels kept int8 (`QuantDense.weight_q`)."""
    jcfg = JDecoderConfig.tiny(quantize_weights=True, tie_embeddings=True)
    model = port_model(jcfg, jax_params(jcfg))
    qd = [m for m in model.modules() if isinstance(m, QuantDense)]
    assert len(qd) == 7 * jcfg.num_layers
    assert all(m.weight_q.dtype == torch.int8 for m in qd)
    assert not hasattr(model, "lm_head")


@pytest.mark.parametrize("arch", ["llama", "mistral"])
def test_hf_causal_lm_through_the_converter(arch):
    """HF's model, random init, converted by `convert_llama_state_dict`:
    the port's f32 logits within 1e-4 of HF's."""
    transformers = pytest.importorskip("transformers")
    kw = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              rms_norm_eps=1e-5, rope_theta=10000.0,
              tie_word_embeddings=False)
    torch.manual_seed(0)
    if arch == "llama":
        hf = transformers.LlamaForCausalLM(
            transformers.LlamaConfig(attention_bias=False, **kw))
    else:
        hf = transformers.MistralForCausalLM(
            transformers.MistralConfig(sliding_window=None, **kw))
    hf = hf.eval()
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = DecoderConfig(vocab_size=256, hidden_size=32, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=64,
                        rope_theta=10000.0, max_seq_len=64,
                        dtype=torch.float32)
    model = load_decoder_params(build_decoder(cfg, "cpu"),
                                convert_llama_state_dict(state))
    ids = torch.as_tensor(_ids(4, (2, 12), 256), dtype=torch.long)
    with torch.no_grad():
        want = hf(ids).logits
        got = model(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    gen = TextGenerator(cfg, device="cpu")
    gen.load_converted(state)
    out = gen.generate_ids(ids[:1].numpy(), np.asarray([12]),
                           SamplingConfig(max_new_tokens=5, eos_id=-1))
    with torch.no_grad():
        want_ids = hf.generate(ids[:1], max_new_tokens=5, do_sample=False,
                               pad_token_id=0)[0, 12:]
    np.testing.assert_array_equal(out[0], want_ids.numpy())


def test_random_init_is_seeded_and_jax_shaped():
    """The seeded init: the same seed gives the same weights; int8 kernels
    are round(normal · 42) clipped to ±127 with scales 0.01."""
    cfg = DecoderConfig.tiny(quantize_weights=True, tie_embeddings=True)
    a = TextGenerator(cfg, rng_seed=3, device="cpu").load()
    b = TextGenerator(cfg, rng_seed=3, device="cpu").load()
    c = TextGenerator(cfg, rng_seed=4, device="cpu").load()
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layer_0.gate_proj.weight_q"],
                           sc["layer_0.gate_proj.weight_q"])
    w = sa["layer_0.gate_proj.weight_q"].float()
    assert w.abs().max() == 127 and 38 < w.std() < 46
    assert torch.all(sa["layer_0.gate_proj.scale"] == 0.01)
    emb = sa["embed_tokens.weight"]
    assert emb.dtype == torch.float32
    assert abs(emb.std().item() - 64 ** -0.5) < 0.01
