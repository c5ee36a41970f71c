"""Flash attention at head widths the kernels are not built for (ROADMAP
C-20), on the CPU, against the JAX package.

The JAX Pallas kernels take any Dh; they run here in interpret mode. The
port's forward kernel fills the columns past Dh with zeros as it loads, and
its backward kernels get q, k, v and dO padded with zero columns to the
next width they are built for (`ops.flash_attention.KERNEL_WIDTHS`). On the
CPU the wrappers take the plain twins, so the padding is held here around
the twins, bit for bit; the kernels are held to the twins on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import BgeM3Model as JBgeM3Model
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.ops.flash_attention_bwd import (
    _fwd_with_stats as j_fwd_with_stats,
)
from rag_dpo_tpu.ops.flash_attention_bwd import (
    flash_attention_fused as j_flash_attention_fused,
)
from rag_dpo_tpu_torch.models import BgeM3Config, BgeM3Model, EncoderConfig
from rag_dpo_tpu_torch.models.convert import load_flax_params
from rag_dpo_tpu_torch.ops.flash_attention import (
    KERNEL_WIDTHS,
    flash_attention,
    flash_attention_plain,
    kernel_width,
    pad_head,
)
from rag_dpo_tpu_torch.ops.flash_attention_bwd import (
    _kernel_args,
    _row_delta,
    _unpad,
    flash_attention_fused,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
)

torch.backends.cuda.matmul.allow_tf32 = False

WIDTHS = (8, 24, 40, 80, 96, 160, 320)
# f32 sums of Dh ≤ 320 products and of ≤ 40 keys, in another order than
# XLA's; unit Gaussian inputs
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
LENGTHS = [40, 0, 17]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(dh, seed, n=3, b=3, h=2, s=40):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, dh)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("dh", WIDTHS)
def test_forward_and_lse_match_jax_at_any_width(dh):
    q, k, v = _qkv(dh, dh)
    lens = np.asarray(LENGTHS, np.int32)
    jout, jlse, _ = j_fwd_with_stats(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(lens),
        float(dh) ** -0.5, 16, 16, True)
    out, lse = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(lens), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse)[:, :, :q.shape[2]],
                               **FWD_TOL)
    assert (out[1] == 0).all() and (lse[1] == -1e20).all()


@pytest.mark.parametrize("dh", WIDTHS)
def test_gradients_match_jax_at_any_width(dh):
    q, k, v, w = _qkv(dh, 100 + dh, n=4)
    lens = np.asarray(LENGTHS, np.int32)
    w = w * (np.arange(q.shape[2])[None, :] < lens[:, None])[:, None, :,
                                                            None]

    def j_loss(q, k, v):
        out = j_flash_attention_fused(q, k, v, jnp.asarray(lens),
                                      block_q=16, block_k=16)
        return jnp.sum(out * w), out

    (_, jout), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                            has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_fused(tq, tk, tv, torch.from_numpy(lens))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=f"d{name}", **GRAD_TOL)
    assert not tq.grad[1].any() and not tk.grad[1].any()


@pytest.mark.parametrize("dh", WIDTHS)
def test_padded_backward_equals_the_unpadded_twins_bit_for_bit(dh):
    """What the backward wrappers do on the card, around the twins: q, k, v
    and dO padded to the kernels' width (`_kernel_args`), the gradients
    sliced back (`_unpad`), scale from the true Dh. Inputs in eighths make
    every product and sum exact, so a zero column must change no bit."""
    rng = np.random.default_rng(dh)
    q, k, v, g = (torch.from_numpy(
        (rng.integers(-8, 9, (3, 2, 40, dh)) / 32).astype(np.float32))
        for _ in range(4))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    out, lse = flash_attention_plain(q, k, v, lengths, return_lse=True)
    dd = _row_delta(out, g)
    scale = dh ** -0.5
    args = (q, k, v, lengths, lse, dd, g, scale)
    pq, pk, pv, pg, plen, plse, pdd = _kernel_args(q, k, v, lengths, lse,
                                                   dd, g)
    width = kernel_width(dh)
    assert pq.shape[-1] == width and pq.is_contiguous()
    assert torch.equal(pq[..., :dh], q) and not pq[..., dh:].any()
    padded = (pq, pk, pv, plen, plse, pdd, pg, scale)
    assert torch.equal(_unpad(flash_bwd_dq_plain(*padded), dh),
                       flash_bwd_dq_plain(*args))
    for got, want in zip(flash_bwd_dkv_plain(*padded),
                         flash_bwd_dkv_plain(*args)):
        assert torch.equal(_unpad(got, dh), want)
    # and the forward's zero-filled columns, with the true Dh's scale
    pout, plse2 = flash_attention_plain(pq, pk, pv, lengths, scale,
                                        return_lse=True)
    assert torch.equal(pout[..., :dh], out) and torch.equal(plse2, lse)


def test_kernel_widths_cover_every_width_up_to_512():
    assert [kernel_width(d) for d in (1, 8, 16, 17, 80, 200, 320, 512)] == [
        16, 16, 16, 32, 128, 256, 512, 512]
    assert KERNEL_WIDTHS[-1] == 512
    with pytest.raises(ValueError):
        kernel_width(513)
    x = torch.ones(2, 3, 5)
    assert pad_head(x, 5) is x
    assert pad_head(x, 8).shape == (2, 3, 8) and not pad_head(x, 8)[..., 5:].any()


def test_encoder_with_head_width_80_matches_flax():
    """A 2-layer encoder at hidden 320 and 4 heads (Dh 80, which the
    kernels took on no card before): flash on, Flax weights carried
    across."""
    enc = dict(vocab_size=512, hidden_size=320, num_layers=2, num_heads=4,
               intermediate_size=640, max_position_embeddings=130,
               use_flash_attention=True, flash_block_q=16, flash_block_k=16)
    jcfg = JBgeM3Config(encoder=JEncoderConfig(**enc), colbert_dim=32)
    rng = np.random.default_rng(5)
    lengths = np.asarray([40, 23, 6], np.int32)
    ids = np.full((3, 40), 1, np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(4, 512, size=n)
        ids[i, 0], ids[i, n - 1] = 0, 2
    jmodel = JBgeM3Model(jcfg)
    params = jmodel.init(jax.random.key(4), jnp.asarray(ids))
    jout = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(lengths))
    model = BgeM3Model(BgeM3Config(encoder=EncoderConfig(**enc),
                                   colbert_dim=32))
    load_flax_params(model, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(lengths))
    for got, want in ((out.dense, jout.dense), (out.sparse, jout.sparse),
                      (out.colbert, jout.colbert)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=3e-5, rtol=3e-5)
