"""Slice 2, training: the port against the JAX package on the CPU.

The same numpy inputs and Flax parameters go through the JAX functions (the
Pallas flash kernels in interpret mode, as `tests/test_flash_bwd.py` runs
them) and through the port, whose flash backward takes its plain twins for
CPU tensors. The CUDA kernels are held to those twins on the card by
`chip_smoke.py` and `tests/test_torch_cuda.py`.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_dpo_tpu.evals import train_encoder as j_train_encoder
from rag_dpo_tpu.evals.synthetic import build_synthetic_corpus
from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import BgeM3Model as JBgeM3Model
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.models.convert import load_params_npz as j_load_params_npz
from rag_dpo_tpu.ops.flash_attention_bwd import (
    flash_attention_fused as j_flash_attention_fused,
)
from rag_dpo_tpu.parallel import MeshSpec, create_mesh
from rag_dpo_tpu.tokenize import HashedTokenizer as JHashedTokenizer
from rag_dpo_tpu.train import TrainConfig as JTrainConfig
from rag_dpo_tpu.train import create_train_state as j_create_train_state
from rag_dpo_tpu.train import make_sharded_train_step
from rag_dpo_tpu.train.contrastive import info_nce_loss as j_info_nce_loss
from rag_dpo_tpu.train.loop import PairBatcher as JPairBatcher
from rag_dpo_tpu_torch.evals import train_encoder
from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
from rag_dpo_tpu_torch.models.convert import (
    flax_to_state_dict,
    load_params_npz,
    save_params_npz,
    state_dict_to_flax,
)
from rag_dpo_tpu_torch.ops import flash_attention_bwd
from rag_dpo_tpu_torch.ops.flash_attention import flash_attention
from rag_dpo_tpu_torch.tokenize import HashedTokenizer
from rag_dpo_tpu_torch.train import (
    TrainConfig,
    create_train_state,
    make_train_step,
)
from rag_dpo_tpu_torch.train.checkpoint import TrainCheckpointer
from rag_dpo_tpu_torch.train.contrastive import (
    contrastive_loss,
    info_nce_loss,
    learning_rate_at,
)
from rag_dpo_tpu_torch.train.loop import (
    LoopConfig,
    PairBatcher,
    train_retriever,
)

torch.backends.cuda.matmul.allow_tf32 = False

REPO = pathlib.Path(__file__).resolve().parent.parent
DATASET = REPO / "rag_dpo_tpu" / "evals" / "data" / "qa_dataset.json"
TRAINED = REPO / "rag_dpo_tpu" / "evals" / "data" / "trained_encoder_v2.npz"
# f32 throughout; the frameworks sum matmuls, softmax and LayerNorm
# statistics in different orders (~1e-7 relative per op). Attention
# gradients: ≤ 40 keys, unit-scale inputs.
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# one train step: the InfoNCE temperature of 0.05 scales the logits by 20,
# which carries the encoders' ~1e-6 differences into the gradients
STEP_TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: each pytest-xdist worker would otherwise start
    one per core, and oversubscribed, torch's CPU ops run ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(flash=True, remat=False, layers=1, **kw):
    """`tests/test_train.py::_cfg`, in both packages."""
    enc = dict(vocab_size=256, hidden_size=32, num_layers=layers, num_heads=2,
               intermediate_size=64, max_position_embeddings=66,
               use_flash_attention=flash, remat=remat)
    train = dict(warmup_steps=2, **kw)
    return (JTrainConfig(model=JBgeM3Config(encoder=JEncoderConfig(**enc),
                                            colbert_dim=16), **train),
            TrainConfig(model=BgeM3Config(encoder=EncoderConfig(**enc),
                                          colbert_dim=16), **train))


def _ids(rng, lengths, s, vocab=256, pad=1):
    ids = np.full((len(lengths), s), pad, np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(4, vocab, size=n)
        ids[i, 0], ids[i, n - 1] = 0, 2
    return ids, np.asarray(lengths, np.int32)


def _batch(seed, negatives: bool, s=12):
    rng = np.random.default_rng(seed)
    batch = {}
    for name, lens in (("query", [12, 5, 9, 3]), ("passage", [12, 12, 7, 10]),
                       ("negative", [11, 1, 12, 6])):
        if name == "negative" and not negatives:
            continue
        batch[f"{name}_ids"], batch[f"{name}_lengths"] = _ids(rng, lens, s)
    if negatives:
        batch["negative_valid"] = np.asarray([True, False, True, True])
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("_ids")
            else torch.from_numpy(v) for k, v in batch.items()}


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, j_create_train_state(jcfg, seed).params)


def _jax_loss_fn(jcfg):
    """The loss of `make_sharded_train_step` (`contrastive.py:162-179`)."""
    model = JBgeM3Model(dataclasses.replace(jcfg.model, with_sparse=False,
                                            with_colbert=False))

    def loss_fn(params, batch):
        q = model.apply(params, batch["query_ids"], batch["query_lengths"])
        p = model.apply(params, batch["passage_ids"],
                        batch["passage_lengths"])
        n_emb = n_valid = None
        if "negative_ids" in batch:
            n_emb = model.apply(params, batch["negative_ids"],
                                batch["negative_lengths"]).dense
            n_valid = batch["negative_valid"]
        return j_info_nce_loss(q.dense, p.dense, jcfg.temperature, None,
                               n_emb=n_emb, n_valid=n_valid)

    return loss_fn


def _grads(model) -> dict:
    return {name: (p.grad if p.grad is not None
                   else torch.zeros_like(p)).numpy()
            for name, p in model.named_parameters()}


# ------------------------------------------------------ flash backward
@pytest.mark.parametrize("lengths,masked_loss", [
    (None, True),             # full lengths
    ([40, 0, 17], True),      # ragged, with a zero-length row
    ([33, 5, 0], False),      # a loss that also weighs the padded rows
], ids=["full", "ragged-empty-row", "unmasked-loss"])
def test_flash_gradients_match_jax_with_a_kernel_like_forward(
        monkeypatch, lengths, masked_loss):
    """The fault of the CUDA path: its forward is a kernel whose output has
    no grad_fn. Here the forward is detached the same way, so every
    gradient below comes from the fused backward alone."""
    monkeypatch.setattr(
        flash_attention_bwd, "flash_attention",
        lambda *a, **kw: tuple(x.detach() for x in flash_attention(*a, **kw)))
    rng = np.random.default_rng(7)
    b, h, s, dh = 3, 2, 40, 16
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    lens = np.asarray(lengths if lengths else [s] * b, np.int32)
    w = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    if masked_loss:
        w = w * (np.arange(s)[None, :] < lens[:, None])[:, None, :, None]

    def j_loss(q, k, v):
        out = j_flash_attention_fused(q, k, v, jnp.asarray(lens),
                                      block_q=16, block_k=16)
        return jnp.sum(out * w)

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_bwd.flash_attention_fused(
        tq, tk, tv, None if lengths is None else torch.from_numpy(lens))
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=f"d{name}", **GRAD_TOL)
    for z in np.flatnonzero(lens == 0):  # a row with no keys learns nothing
        assert not tq.grad[z].any() and not tk.grad[z].any()


def test_flash_fused_without_gradients_runs_the_forward_alone(monkeypatch):
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return flash_attention(*a, **kw)

    monkeypatch.setattr(flash_attention_bwd, "flash_attention", spy)
    q = torch.randn(2, 2, 8, 16, requires_grad=True)
    with torch.no_grad():
        out = flash_attention_bwd.flash_attention_fused(q, q, q)
    with torch.inference_mode():
        flash_attention_bwd.flash_attention_fused(q, q, q)
    flash_attention_bwd.flash_attention_fused(q.detach(), q.detach(),
                                              q.detach())
    assert out.grad_fn is None and calls == [False, False, False]
    flash_attention_bwd.flash_attention_fused(q, q, q)
    assert calls[-1] is True


# ------------------------------------------------------- one train step
@pytest.mark.parametrize("negatives", [False, True],
                         ids=["in-batch", "hard-negatives"])
def test_train_step_loss_and_gradients_match_jax(negatives):
    jcfg, cfg = _cfg(flash=True)
    params = _jax_params(jcfg)
    batch = _batch(3, negatives)
    (j_loss, j_acc), j_grads = jax.value_and_grad(
        _jax_loss_fn(jcfg), has_aux=True)(params, _to_jax(batch))

    state = create_train_state(cfg, params=params, device="cpu")
    loss, acc = contrastive_loss(state.model, _to_torch(batch),
                                 cfg.temperature)
    loss.backward()
    assert float(acc) == pytest.approx(float(j_acc))
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    expected = flax_to_state_dict(jax.tree.map(np.asarray, j_grads))
    grads = _grads(state.model)
    assert grads.keys() == expected.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, expected[name], err_msg=name,
                                   **STEP_TOL)
    # the dense-only loss leaves the heads without gradient, as in JAX
    assert not grads["sparse_head.weight"].any()
    assert not grads["colbert_head.weight"].any()


def test_info_nce_masks_invalid_negatives_like_jax():
    rng = np.random.default_rng(5)
    q, p, n = (rng.standard_normal((6, 8)).astype(np.float32)
               for _ in range(3))
    q, p, n = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (q, p, n))
    valid = np.asarray([True, False, True, True, False, True])
    j_loss, j_acc = j_info_nce_loss(*(jnp.asarray(x) for x in (q, p)), 0.05,
                                    None, n_emb=jnp.asarray(n),
                                    n_valid=jnp.asarray(valid))
    loss, acc = info_nce_loss(*(torch.from_numpy(x) for x in (q, p)), 0.05,
                              n_emb=torch.from_numpy(n),
                              n_valid=torch.from_numpy(valid))
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-6)
    assert float(acc) == pytest.approx(float(j_acc))
    with pytest.raises(ValueError, match="pass mesh="):
        info_nce_loss(torch.from_numpy(q), torch.from_numpy(p), 0.05,
                      axis_name="data")


# ------------------------------------------------------------ optimizer
def test_four_steps_match_optax(eight_devices):
    """lr 0 on the first step (the schedule is read before the update)
    and a clip that fires: the parameters after 4 steps and the loss
    trajectory match the JAX step. At weight decay 0.01 the decay moves a
    parameter less than the bound below; the next test holds it."""
    jcfg, cfg = _cfg(flash=False, learning_rate=1e-3, grad_clip=0.05)
    params = _jax_params(jcfg, seed=1)
    batch = _batch(4, negatives=True)

    step, jstate = make_sharded_train_step(
        jcfg, create_mesh(MeshSpec(data=1, model=1, shard=1)),
        j_create_train_state(jcfg, 1))
    j_losses = []
    for _ in range(4):
        jstate, metrics = step(jstate, _to_jax(batch))
        j_losses.append(float(metrics["loss"]))

    state = create_train_state(cfg, params=params, device="cpu")
    step_fn = make_train_step(cfg, state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses = []
    for i in range(4):
        state, metrics = step_fn(state, _to_torch(batch))
        losses.append(float(metrics["loss"]))
        if i == 0:
            norm = torch.linalg.vector_norm(torch.stack(
                [p.grad.norm() for p in state.model.parameters()
                 if p.grad is not None]))
            assert float(norm) > cfg.grad_clip  # the clip fired
            for k, v in state.model.state_dict().items():
                assert torch.equal(v, before[k]), k  # lr 0: unchanged
    assert state.step == 4 and int(jstate.step) == 4
    assert learning_rate_at(cfg, 0) == 0.0
    assert learning_rate_at(cfg, 1) == pytest.approx(5e-4)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    expected = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    lr_sum = sum(learning_rate_at(cfg, c) for c in range(4))
    for name, value in state.model.state_dict().items():
        # Adam normalises each gradient element, so a weight travels up to
        # ~Σ lr whatever its gradient's size, and an element whose gradient
        # nearly cancels carries the frameworks' ~1e-6 relative gradient
        # differences into its direction: 1% of that travel is the bound.
        # The key bias's gradient is 0 in exact arithmetic (a per-query
        # constant added to every score leaves the softmax unchanged), so
        # Adam normalises rounding residue there and only Σ lr bounds it.
        tol = (dict(atol=lr_sum, rtol=0) if name.endswith("key.bias")
               else dict(atol=0.01 * lr_sum, rtol=1e-5))
        np.testing.assert_allclose(value.numpy(), expected[name],
                                   err_msg=name, **tol)


def test_clip_adamw_decays_every_parameter_like_optax():
    """Weight decay 0.5 moves each parameter by ~lr·0.5·|p| a step, far
    above the tolerance: a weight, a non-zero bias, a LayerNorm-like scale
    of ones and a head without gradient (decayed only) all match optax's
    chain step for step, with the clip firing on some steps and not on
    others. An AdamW that skipped biases and norms, or decayed nothing,
    fails here."""
    from rag_dpo_tpu.train.contrastive import make_optimizer as j_make_tx

    from rag_dpo_tpu_torch.train.contrastive import make_optimizer

    rng = np.random.default_rng(11)
    shapes = {"kernel": (4, 3), "bias": (3,), "scale": (3,), "head": (2, 3)}
    init = {n: rng.standard_normal(s).astype(np.float32) + 0.5
            for n, s in shapes.items()}
    init["scale"] = np.ones(3, np.float32)
    jcfg, cfg = _cfg(learning_rate=1e-2, weight_decay=0.5, grad_clip=1.0)
    tx = j_make_tx(jcfg)
    j_params = {n: jnp.asarray(v) for n, v in init.items()}
    j_opt = tx.init(j_params)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = make_optimizer(cfg, list(params.values()))
    for step, size in enumerate((3.0, 0.05, 4.0, 0.1, 0.2)):
        grads = {n: (rng.standard_normal(s) * size).astype(np.float32)
                 for n, s in shapes.items()}
        grads["head"] = np.zeros(shapes["head"], np.float32)
        updates, j_opt = tx.update({n: jnp.asarray(g)
                                    for n, g in grads.items()},
                                   j_opt, j_params)
        j_params = jax.tree.map(lambda p, u: p + u, j_params, updates)
        for n, p in params.items():
            p.grad = None if n == "head" else torch.from_numpy(grads[n])
        opt.step()
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(j_params[n]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{n}, step {step}")
    # the decay showed: the head, which had no gradient, shrank by
    # Π(1 − 0.5·lr) ≈ 0.983 over the five steps
    assert np.all(np.abs(params["head"].detach().numpy())
                  < 0.99 * np.abs(init["head"]))


def test_learning_rate_schedule_matches_optax():
    import optax

    _, cfg = _cfg(learning_rate=3e-4)
    cfg = dataclasses.replace(cfg, warmup_steps=80)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 80, 10_000)
    for count in (0, 1, 40, 79, 80, 81, 5000, 9999, 10_000, 12_000):
        assert learning_rate_at(cfg, count) == pytest.approx(
            float(sched(count)), rel=1e-6, abs=3e-10), count


# ---------------------------------------------------------------- remat
def test_remat_gives_the_same_loss_and_gradients():
    batch = _to_torch(_batch(6, negatives=True))
    results = []
    for remat in (False, True):
        _, cfg = _cfg(flash=True, remat=remat, layers=2)
        state = create_train_state(cfg, rng_seed=2, device="cpu")
        loss, _ = contrastive_loss(state.model, batch, cfg.temperature)
        loss.backward()
        results.append((float(loss.detach()), _grads(state.model)))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    for name, g in results[0][1].items():
        np.testing.assert_allclose(results[1][1][name], g, rtol=1e-6,
                                   atol=1e-9, err_msg=name)


# ----------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_max_to_keep(tmp_path):
    _, cfg = _cfg()
    state = create_train_state(cfg, device="cpu")
    ckpt = TrainCheckpointer(tmp_path / "ckpt", max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    step_fn = make_train_step(cfg, state)
    batch = _to_torch(_batch(8, negatives=False))
    for _ in range(3):
        state, _ = step_fn(state, batch)
        assert ckpt.save(state)
    assert not ckpt.save(state)  # step 3 exists
    assert ckpt.save(state, force=True)
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3

    restored = ckpt.restore(create_train_state(cfg, rng_seed=9,
                                               device="cpu"))
    assert restored.step == 3
    for name, value in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[name], value), name
    assert restored.optimizer.param_groups[0]["count"] == 3
    # the restored state steps exactly as the original does
    state, m1 = step_fn(state, batch)
    restored, m2 = make_train_step(cfg, restored)(restored, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for name, value in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[name], value), name
    older = ckpt.restore(create_train_state(cfg, device="cpu"), step=2)
    assert older.step == 2
    ckpt.close()


def test_train_loop_runs_checkpoints_and_resumes(tmp_path):
    _, cfg = _cfg(flash=False)
    pairs = [(f"question sur le sujet {i}",
              f"passage documentaire détaillant le sujet {i} et ses "
              "obligations") for i in range(16)]
    metrics_path = tmp_path / "metrics.jsonl"
    loop = LoopConfig(batch_size=4, max_steps=6, seq_len=16,
                      checkpoint_every=3, log_every=2)
    state = train_retriever(pairs, cfg, "cpu", tmp_path / "ckpt", loop,
                            metrics_path=metrics_path)
    assert state.step == 6
    entries = [json.loads(line) for line in
               metrics_path.read_text().splitlines()]
    assert [e["step"] for e in entries] == [1, 2, 4, 6]
    assert all(np.isfinite(e["loss"]) for e in entries)
    loop2 = dataclasses.replace(loop, max_steps=8)
    state2 = train_retriever(pairs, cfg, "cpu", tmp_path / "ckpt", loop2,
                             metrics_path=metrics_path)
    assert state2.step == 8
    entries = [json.loads(line) for line in
               metrics_path.read_text().splitlines()]
    assert [e["step"] for e in entries[4:]] == [7, 8]


# ------------------------------------------------------------------ npz
def test_npz_from_the_port_gives_the_same_heads_in_jax(tmp_path):
    jcfg, cfg = _cfg(flash=False)
    state = create_train_state(cfg, rng_seed=4, device="cpu")
    step_fn = make_train_step(cfg, state)
    for _ in range(2):
        state, _ = step_fn(state, _to_torch(_batch(2, negatives=False)))
    path = tmp_path / "trained.npz"
    save_params_npz(state_dict_to_flax(state.model), path)
    assert sorted(np.load(path).files) == sorted(
        k for k in np.load(TRAINED).files if "layer_1" not in k)

    ids, lengths = _ids(np.random.default_rng(0), [12, 4, 9], 12)
    j_out = JBgeM3Model(jcfg.model).apply(
        jax.tree.map(jnp.asarray, j_load_params_npz(path)),
        jnp.asarray(ids), jnp.asarray(lengths))
    state.model.eval()
    with torch.no_grad():
        out = state.model(torch.from_numpy(ids).long(),
                          torch.from_numpy(lengths))
    tol = dict(atol=2e-5, rtol=2e-5)
    for head in ("dense", "sparse", "colbert"):
        np.testing.assert_allclose(getattr(out, head).numpy(),
                                   np.asarray(getattr(j_out, head)),
                                   err_msg=head, **tol)
    reloaded = flax_to_state_dict(load_params_npz(path))
    for name, value in state.model.state_dict().items():
        np.testing.assert_array_equal(reloaded[name], value.numpy())


# ------------------------------------------------------------ host code
@pytest.fixture(scope="module")
def corpus():
    return build_synthetic_corpus(json.loads(DATASET.read_text()))


def test_training_pairs_and_hard_negatives_equal_jax(corpus):
    pairs, groups = train_encoder.build_training_pairs(corpus,
                                                       return_groups=True)
    j_pairs, j_groups = j_train_encoder.build_training_pairs(
        corpus, return_groups=True)
    assert pairs == j_pairs and groups == j_groups
    # a slice keeps the O(pairs × chunks) mining short
    sub = slice(0, 120)
    assert (train_encoder.mine_hard_negatives(pairs[sub], groups[sub], corpus)
            == j_train_encoder.mine_hard_negatives(j_pairs[sub],
                                                   j_groups[sub], corpus))
    assert train_encoder.family_key("twin_cnil_7") == "cnil_7"


@pytest.mark.parametrize("mode", ["plain", "grouped", "negatives"])
def test_pair_batcher_equals_jax(corpus, mode):
    pairs, groups = train_encoder.build_training_pairs(corpus,
                                                       return_groups=True)
    pairs, groups = pairs[:96], groups[:96]
    kw = {}
    if mode == "grouped":
        kw["groups"] = groups
    if mode == "negatives":
        kw["negatives"] = [None if i % 5 == 0 else pairs[(i + 7) % 96][1]
                           for i in range(96)]
    batcher = PairBatcher(pairs, HashedTokenizer(256), 16, 48, seed=3, **kw)
    j_batcher = JPairBatcher(pairs, JHashedTokenizer(256), 16, 48, seed=3,
                             **kw)
    for step in (0, 5, 6, 13):  # 6 batches an epoch: two epochs
        got, want = batcher.batch_at(step), j_batcher.batch_at(step)
        assert got.keys() == want.keys()
        for key, value in got.items():
            np.testing.assert_array_equal(value.numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"{key} at {step}")


def test_recipe_trains_and_saves_the_shared_npz(tmp_path):
    out = tmp_path / "encoder.npz"
    result = train_encoder.train_eval_encoder(
        out, steps=3, batch_size=8, seq_len=32, log_every=1, device="cpu")
    assert result["steps"] == 3 and result["n_pairs"] > 100
    assert result["n_hard_negatives"] > 0
    assert np.isfinite([result["loss_first"], result["loss_last"]]).all()
    assert sorted(np.load(out).files) == sorted(np.load(TRAINED).files)
    # the JAX package's loader and model take it as they take its own
    j_params = j_load_params_npz(out)
    model = JBgeM3Model(JBgeM3Config(
        encoder=JEncoderConfig.tiny(use_flash_attention=False),
        colbert_dim=32))
    ids, lengths = _ids(np.random.default_rng(1), [20, 6], 20, vocab=1024)
    dense = model.apply(jax.tree.map(jnp.asarray, j_params),
                        jnp.asarray(ids), jnp.asarray(lengths)).dense
    np.testing.assert_allclose(np.linalg.norm(np.asarray(dense), axis=1),
                               1.0, rtol=1e-5)
