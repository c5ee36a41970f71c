"""Why the flash backward kernels split their f32 operands, on the CPU.

K8 and K9 (`rag_dpo_tpu_torch/csrc/flash_bwd.cu`) run their five
products (S = Q·Kᵀ, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO) on
the tensor cores, whose f32 inputs are TF32: 10 mantissa bits. For f32
accuracy each operand x goes in as big + small, big = x rounded to TF32
on the ALU (`(bits + 0x1000) & 0xffffe000`) and small = x − big, of
which the tensor core reads the top 19 bits; a product is big·small' +
small·big' + big·big' (3xTF32). No CPU runs the kernels, so this file emulates that
operand handling in torch integer ops, with each partial product exact
(float64) and rounded to f32, and holds the gradients it gives to JAX's
`flash_attention_fused` (its Pallas kernels in interpret mode, as
`tests/test_torch_train.py` runs them) within the tolerance the card's
checks hold the kernels to, 1e-4 (`chip_smoke.py::FLASH_BWD_TOL`,
`tests/test_torch_cuda.py::TOL`). One TF32 product in place of three errs
over a hundred times more and fails that tolerance: hence the split.

This tests the arithmetic argument, not the kernels: it calls no code of
the port, and the kernels themselves are held to their twins on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.ops.flash_attention_bwd import (
    flash_attention_fused as j_flash_attention_fused,
)

TOL = 1e-4  # f32, the card's tolerance of the kernels against their twins
SHAPE = (2, 4, 192, 64)  # the training shape's S and Dh
LENGTHS = [192, 77]
TF32_MASK = -0x2000  # 0xffffe000 as an int32: the bits a TF32 keeps


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """x rounded to TF32 as the kernels do on the ALU (ties away)."""
    return ((x.view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)


def tensor_core(x):
    """x as the tensor core reads it: its top 19 bits."""
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tensor_core(x - big)


def product_3xtf32(a, b):
    """a @ b as big·small' + small·big' + big·big', each partial product
    exact, the sum rounded to f32."""
    (ab, ax), (bb, bx) = split(a), split(b)
    return sum(x.double() @ y.double()
               for x, y in ((ab, bx), (ax, bb), (ab, bb))).float()


def product_tf32(a, b):
    """a @ b as one TF32 product."""
    return (tf32(a).double() @ tf32(b).double()).float()


def backward(q, k, v, g, lengths, product):
    """(dq, dk, dv) as K8 and K9 compute them, with `product` for each of
    their five matrix products; lse and D of the exact forward."""
    s = q.shape[2]
    scale = q.shape[-1] ** -0.5
    keys = torch.arange(s)[None, :] < lengths[:, None]
    key_ok, row_ok = keys[:, None, None, :], keys[:, None, :, None]
    logits = (q.double() @ k.double().transpose(-1, -2)) * scale
    logits = torch.where(key_ok, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    out = torch.softmax(logits, dim=-1) @ v.double()
    dd = (g.double() * out).sum(-1, keepdim=True).float()
    lse = lse.float()
    scores = product(q, k.transpose(-1, -2)) * scale
    p = torch.where(key_ok & row_ok, torch.exp(scores - lse), 0.0)
    ds = p * (product(g, v.transpose(-1, -2)) - dd)
    dq = torch.where(row_ok, product(ds, k) * scale, 0.0)
    dk = product(ds.transpose(-1, -2), q) * scale
    dv = product(p.transpose(-1, -2), g)
    return dq, dk, dv


def test_split_keeps_f32_accuracy_where_one_tf32_product_does_not():
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.standard_normal(SHAPE).astype(np.float32)
                  for _ in range(4))
    lens = np.asarray(LENGTHS, np.int32)
    g = g * (np.arange(SHAPE[2])[None, :] < lens[:, None])[:, None, :, None]

    def j_loss(q, k, v):
        out = j_flash_attention_fused(q, k, v, jnp.asarray(lens),
                                      block_q=64, block_k=64)
        return jnp.sum(out * g)

    j_grads = [np.asarray(x) for x in jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]
    args = [torch.from_numpy(x) for x in (q, k, v, g)]
    lengths = torch.from_numpy(lens)
    split3 = backward(*args, lengths, product_3xtf32)
    single = backward(*args, lengths, product_tf32)
    err3, err1 = [], []
    for name, got, one, want in zip(("dq", "dk", "dv"), split3, single,
                                    j_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL,
                                   err_msg=name)
        err3.append(float(np.abs(got.numpy() - want).max()))
        err1.append(float(np.abs(one.numpy() - want).max()))
    # the split is within the tolerance by a wide margin; one TF32
    # product is not within it at all
    assert max(err1) >= 100 * max(err3), (err1, err3)
    assert max(err1) > TOL, err1
    # padded query rows learn nothing, padded keys give nothing
    assert not split3[0][1, :, 77:].any() and not split3[1][1, :, 77:].any()
