"""`models/flax_init.py`: Flax's seeded initialisation in the port.

The port's draws against `jax.random` and Flax's `model.init` on the CPU:
bits and uniforms bit for bit; `erfinv_f32` within 2 ulp of
`jax.lax.erf_inv` (its log1p and XLA's fused multiply-adds round
differently); normal and truncated normal draws within 3 ulp (the erfinv's
2, then the √2 product); every f32 leaf of every model family within 4 ulp
(one more rounding, the stddev product); bf16 draws and int8 kernels equal
(an int8 value may be one off where an ulp moves a rounding tie, in at
most 1e-4 of a kernel: none at these sizes).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import scope as flax_scope
from flax.traverse_util import flatten_dict

from rag_dpo_tpu.models.bge_m3 import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models.bge_m3 import BgeM3Model as JBgeM3Model
from rag_dpo_tpu.models.cross_encoder import CrossEncoderModel as JCross
from rag_dpo_tpu.models.decoder import DecoderConfig as JDecoderConfig
from rag_dpo_tpu.models.decoder import DecoderModel as JDecoderModel
from rag_dpo_tpu.models.encoder import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.models.llava import LlavaConfig as JLlavaConfig
from rag_dpo_tpu.models.llava import LlavaGenerator as JLlavaGenerator
from rag_dpo_tpu.providers import Embedder as JEmbedder
from rag_dpo_tpu.providers import EmbedderConfig as JEmbedderConfig
from rag_dpo_tpu_torch.models import flax_init
from rag_dpo_tpu_torch.models.bge_m3 import BgeM3Config, build_bge_m3
from rag_dpo_tpu_torch.models.cross_encoder import CrossEncoderModel
from rag_dpo_tpu_torch.models.decoder import (
    DecoderConfig,
    build_decoder,
    decoder_flax_tree,
    init_random_,
)
from rag_dpo_tpu_torch.models.encoder import EncoderConfig
from rag_dpo_tpu_torch.models.encoder import init_random_ as init_encoder_
from rag_dpo_tpu_torch.models.llava import LlavaConfig, LlavaGenerator
from rag_dpo_tpu_torch.models.sharding import TensorParallel, param_spec
from rag_dpo_tpu_torch.providers import Embedder, EmbedderConfig

SEEDS = (0, 1, 2**31 + 5)
SHAPES = ((7,), (3, 5), (64, 33), (2, 3, 4), (1000,))
DRAW_ULPS = 3       # normal / truncated normal against jax.random
LEAF_ULPS = 4       # an f32 leaf against Flax's model.init
INT8_OFF_SHARE = 1e-4
_ODD = dict(hidden_size=96, intermediate_size=160, vocab_size=300)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ulps(want, got) -> int:
    """The largest gap in f32 ulps (bit patterns of same-signed values)."""
    a = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def test_flax_keeps_the_rng_separator_off():
    """The recipe hashes the path's names with no separator between them,
    which is Flax's default."""
    assert flax.config.flax_fix_rng_separator is False


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk = jax.random.key(seed)
    key = flax_init.seed_key(seed)
    assert key == tuple(int(v) for v in jax.random.key_data(jk))
    assert flax_init.fold_in(key, 0xDEADBEEF) == tuple(
        int(v) for v in jax.random.key_data(jax.random.fold_in(
            jk, np.uint32(0xDEADBEEF))))
    for path, counter in ((("encoder", "layer_0", "attention", "query"), 1),
                          ((), 3), (("layer_12", "fc1"), 2)):
        want = flax_scope._fold_in_static(jk, (*path, counter))
        assert flax_init.flax_param_key(seed, path, counter) == tuple(
            int(v) for v in jax.random.key_data(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniforms_are_jax_bit_for_bit(seed, shape):
    jk, key = jax.random.key(seed), flax_init.seed_key(seed)
    np.testing.assert_array_equal(
        flax_init.random_bits(key, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    erf2 = float(jax.lax.erf(np.float32(2) / np.float32(np.sqrt(2))))
    for minval, maxval in ((0.0, 1.0), (lo, 1.0), (-erf2, erf2)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                             minval, maxval))
        got = flax_init.uniform(key, shape, minval, maxval).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    want = np.asarray(jax.random.uniform(jk, shape, jnp.bfloat16, -erf2,
                                         erf2).astype(jnp.float32))
    got = flax_init.uniform(key, shape, -erf2, erf2, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_truncation_bounds_are_jaxs():
    sq = np.float32(np.sqrt(2))
    want = [float(jax.lax.erf(np.float32(v) / sq)) for v in (-2, 2)]
    assert list(flax_init._erf_bounds(-2.0, 2.0, torch.float32)) == want


def test_erfinv_f32_within_2_ulp_of_xla():
    rng = np.random.default_rng(0)
    tails = np.float32(1) - np.float32(10.0) ** -np.arange(
        1, 8, dtype=np.float32)
    near_one = np.float32(1) - np.arange(1, 20_001, dtype=np.float32) \
        * np.float32(2.0 ** -24)
    x = np.concatenate([rng.uniform(-1, 1, 1_000_000).astype(np.float32),
                        tails, -tails, near_one, -near_one,
                        np.float32([0.0, 1e-30, -1e-30])])
    want = np.asarray(jax.lax.erf_inv(x))
    got = flax_init.erfinv_f32(torch.from_numpy(x)).numpy()
    assert _ulps(want, got) <= 2
    assert torch.isinf(flax_init.erfinv_f32(torch.tensor([1.0, -1.0]))).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_draws_within_ulps(seed):
    jk, key = jax.random.key(seed), flax_init.seed_key(seed)
    shape = (300, 500)
    assert _ulps(jax.random.normal(jk, shape),
                 flax_init.normal(key, shape)) <= DRAW_ULPS
    assert _ulps(jax.random.truncated_normal(jk, -2.0, 2.0, shape),
                 flax_init.truncated_normal(key, -2.0, 2.0, shape)) \
        <= DRAW_ULPS
    for draw, args in ((jax.random.normal, ()),
                       (jax.random.truncated_normal, (-2.0, 2.0))):
        want = np.asarray(draw(jk, *args, shape, jnp.bfloat16)
                          .astype(jnp.float32))
        mine = (flax_init.normal if not args
                else flax_init.truncated_normal)
        got = mine(key, *args, shape, dtype=torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), want)


def _numpy_tree(tree):
    return jax.tree.map(lambda v: (v.numpy() if v.dtype == torch.int8
                                   else v.float().numpy()), tree)


def _assert_tree_matches(want, got):
    """The same leaves; f32 within LEAF_ULPS, bf16 equal, int8 equal but a
    share ≤ INT8_OFF_SHARE one off. → (largest ulp gap, int8 off share)."""
    want = flatten_dict(jax.tree.map(np.asarray, dict(want)), sep="/")
    got = flatten_dict(got, sep="/")
    assert sorted(want) == sorted(got)
    worst, off = 0, 0.0
    for name, w in want.items():
        g = got[name]
        assert w.shape == g.shape, name
        if w.dtype == np.int8:
            d = np.abs(w.astype(np.int32) - g.astype(np.int32))
            assert d.max() <= 1, name
            off = max(off, float((d > 0).mean()))
        elif w.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(g, w.astype(np.float32),
                                          err_msg=name)
        else:
            worst = max(worst, _ulps(w, g))
    assert worst <= LEAF_ULPS
    assert off <= INT8_OFF_SHARE
    return worst, off


@pytest.mark.parametrize("seed", [0, 3])
def test_bge_m3_init_is_flaxs(seed):
    want = JBgeM3Model(JBgeM3Config.tiny()).init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    model = build_bge_m3(BgeM3Config.tiny(), rng_seed=seed, device="cpu")
    _assert_tree_matches(want, _numpy_tree(flax_init.flax_views(model)))


def test_cross_encoder_init_is_flaxs():
    """The `"cross"` arm's model (`EncoderConfig.tiny()`, the reranker's
    seed 1)."""
    want = JCross(JEncoderConfig.tiny()).init(
        jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    model = init_encoder_(CrossEncoderModel(EncoderConfig.tiny()), 1)
    _assert_tree_matches(want, _numpy_tree(flax_init.flax_views(model)))


def test_vit_and_projector_init_is_flaxs():
    """Tower and projector both from key 0, as JAX's `load()` makes them,
    whatever the port's seed."""
    want = JLlavaGenerator(JLlavaConfig.tiny()).load()
    got = LlavaGenerator(LlavaConfig.tiny(), rng_seed=7, device="cpu").load()
    for part in ("vision", "projector"):
        _assert_tree_matches(
            want[part], _numpy_tree(flax_init.flax_views(got[part])))


@pytest.mark.parametrize("seed,kw,tkw", [
    (0, {}, {}),
    (2, {}, {}),
    (0, dict(quantize_weights=True), dict(quantize_weights=True)),
    (1, dict(quantize_weights=True, tie_embeddings=True),
     dict(quantize_weights=True, tie_embeddings=True)),
    (0, dict(param_dtype=jnp.bfloat16), dict(param_dtype=torch.bfloat16)),
    # widths that are no power of two: every stddev rounds
    (2, dict(param_dtype=jnp.bfloat16, **_ODD), dict(
        param_dtype=torch.bfloat16, **_ODD)),
    (2, _ODD, _ODD),
])
def test_decoder_init_is_flaxs(seed, kw, tkw):
    want = JDecoderModel(JDecoderConfig.tiny(**kw)).init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    model = init_random_(build_decoder(DecoderConfig.tiny(**tkw), "cpu"),
                         seed)
    _assert_tree_matches(want, _numpy_tree(decoder_flax_tree(model)
                                           ["params"]))


def test_large_leaves_draw_in_chunks(monkeypatch):
    """A leaf larger than a chunk draws row blocks at their counter
    offsets: the same values as one draw."""
    model = init_random_(build_decoder(DecoderConfig.tiny(), "cpu"), 4)
    monkeypatch.setattr(flax_init, "CHUNK", 100)
    chunked = init_random_(build_decoder(DecoderConfig.tiny(), "cpu"), 4)
    for (name, a), b in zip(model.state_dict().items(),
                            chunked.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("family", ["decoder", "encoder"])
def test_tp_slices_draw_their_block_of_the_whole(family):
    """A tensor-parallel module draws each slice as its block of the whole
    tensor's counters: rank r's leaves equal the whole model's rank-r
    slices."""
    if family == "decoder":
        cfg = DecoderConfig.tiny()
        build = lambda tp: init_random_(build_decoder(cfg, "cpu", tp), 6)
        tree = lambda m: decoder_flax_tree(m)["params"]
    else:
        from rag_dpo_tpu_torch.models.bge_m3 import BgeM3Model
        from rag_dpo_tpu_torch.models.encoder import init_random_ as enc_

        cfg = BgeM3Config.tiny()
        build = lambda tp: enc_(BgeM3Model(cfg, tp), 6)
        tree = flax_init.flax_views
    whole = flatten_dict(tree(build(None)), sep="/")
    for rank in range(2):
        tp = TensorParallel(group=None, size=2, rank=rank)
        part = flatten_dict(tree(build(tp)), sep="/")
        assert sorted(part) == sorted(whole)
        n_split = 0
        for name, leaf in part.items():
            spec = param_spec(tuple(name.split("/")))
            want = whole[name]
            for axis, axis_name in enumerate(spec):
                if axis_name is not None:
                    per = want.shape[axis] // 2
                    want = want.narrow(axis, rank * per, per)
                    n_split += 1
            assert torch.equal(leaf, want), name
        assert n_split


def test_embedder_vectors_match_jax():
    """`Embedder(rng_seed=3)` with no checkpoint: the port's dense vectors
    within 1e-5 of JAX's (reference attention on both)."""
    texts = ["Quelles sont les conditions du télétravail ?",
             "Le congé parental est de trois ans.", "x"]
    jemb = JEmbedder(JEmbedderConfig(model=JBgeM3Config(
        encoder=JEncoderConfig.tiny(use_flash_attention=False))),
        rng_seed=3)
    temb = Embedder(EmbedderConfig(model=BgeM3Config(
        encoder=EncoderConfig.tiny(use_flash_attention=False))),
        rng_seed=3, device="cpu")
    want = np.asarray(jemb.embed(texts)["dense"])
    got = np.asarray(temb.embed(texts)["dense"])
    assert want.shape == got.shape == (3, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_a_generator_is_refused():
    """The seed is an int: a torch.Generator is refused, never drawn
    from."""
    model = build_decoder(DecoderConfig.tiny(), "cpu")
    with pytest.raises(TypeError):
        init_random_(model, torch.Generator())
