"""Why the MaxSim kernel splits its f32 query, on the CPU.

K7 (`rag_dpo_tpu_torch/csrc/maxsim.cu`) runs its products on the tensor
cores, whose f32 inputs are TF32: 10 mantissa bits. The stored ColBERT
rows are f16 (or bf16), which TF32 holds exactly, so they go in as they
are; the f32 query goes in as big + small, big = q rounded to TF32 on the
ALU (`(bits + 0x1000) & 0xffffe000`) and small = q − big, of which the
tensor core reads the top 19 bits, and a product is big·d + small·d. f32
rows are split too: big·big' + big·small' + small·big' (3xTF32). No CPU
runs the kernel, so this file emulates that operand handling in torch
integer ops, with each product exact (float64) and rounded to f32, the
big and small sums kept apart and added as the kernel adds them, and holds
the scores it gives to JAX's `maxsim` (its Pallas kernel in interpret
mode, as `tests/test_torch_maxsim.py` runs it) within the tolerance the
card's checks hold the kernel to (`chip_smoke.py::MAXSIM_TOL`,
`tests/test_torch_cuda.py::MAXSIM_TOL`), at the rerank's width: D 1024,
stored rows of up to 256 tokens, unit vectors as the ColBERT head makes
them. One TF32 product in place of the split errs over a hundred times
more: hence the split.

This tests the arithmetic argument, not the kernel: it calls no code of
the port, and the kernel itself is held to its twin on the card.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rag_dpo_tpu.ops.maxsim import maxsim as j_maxsim

MAXSIM_TOL = dict(rtol=1e-5, atol=1e-4)  # the card's, kernel against twin
Q, LQ, C, LD, D = 1, 32, 6, 256, 1024    # the rerank's widths, fewer rows
TF32_MASK = -0x2000  # 0xffffe000 as an int32: the bits a TF32 keeps
NEG_INF = -1e30


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


def product(d, q):
    """[C, LD, D] · [Q·LQ, D] exact in float64, rounded to f32."""
    return torch.einsum("cmd,ld->lcm", d.double(), q.double()).float()


def dots_split(q, d, f32_rows: bool):
    """Every ⟨q_l, d_m⟩ as the kernel forms it: the big and small products'
    sums apart, then added."""
    qb, qs = split(q)
    if not f32_rows:  # f16 / bf16 rows: exact in TF32
        return product(d, qb) + product(d, qs)
    db, ds = split(d)
    return product(db, qb) + (product(db, qs) + product(ds, qb))


def dots_one_tf32(q, d):
    return product(tf32(d), tf32(q))


def scores(dots, q_mask, d_mask):
    """Masked max over the rows (−1e30 floor), then each query's valid
    tokens added in order, in float64 rounded to f32 (the kernel's
    compensated f32 sum)."""
    sim = torch.where(d_mask[None], dots, NEG_INF)
    mx = sim.amax(dim=-1).clamp_min(NEG_INF).view(Q, LQ, C)
    mx = torch.where(q_mask[:, :, None], mx.double(), 0.0)
    return mx.sum(dim=1).float()


@pytest.mark.parametrize("rows", ["float16", "bfloat16", "float32"])
def test_split_keeps_f32_accuracy_where_one_tf32_product_does_not(rows):
    rng = np.random.default_rng(22)
    qv = rng.standard_normal((Q, LQ, D)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=-1, keepdims=True)
    dv = rng.standard_normal((C, LD, D)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=-1, keepdims=True)
    dv = dv.astype(np.float16 if rows == "float16" else
                   ml_dtypes.bfloat16 if rows == "bfloat16" else np.float32)
    q_mask = np.ones((Q, LQ), bool)
    q_mask[0, 29:] = False
    lens = rng.integers(60, LD + 1, C)
    d_mask = np.arange(LD)[None, :] < lens[:, None]

    want = np.asarray(j_maxsim(*(jnp.asarray(x)
                                 for x in (qv, q_mask, dv, d_mask))))
    q = torch.from_numpy(qv).view(Q * LQ, D)
    d = torch.from_numpy(dv.astype(np.float32))  # widened exactly
    qm, dm = torch.from_numpy(q_mask), torch.from_numpy(d_mask)
    got = scores(dots_split(q, d, rows == "float32"), qm, dm).numpy()
    one = scores(dots_one_tf32(q, d), qm, dm).numpy()

    np.testing.assert_allclose(got, want, **MAXSIM_TOL)
    err_split = float(np.abs(got - want).max())
    err_one = float(np.abs(one - want).max())
    # the split is within the tolerance by a wide margin, near JAX's own
    # f32 rounding; one TF32 product errs over a hundred times more
    assert err_one >= 100 * err_split, (err_one, err_split)
