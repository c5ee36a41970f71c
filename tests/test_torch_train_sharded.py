"""Training on a mesh: the port's `make_sharded_train_step`,
`info_nce_loss(axis_name=)`, `train_retriever` on a mesh, the mesh
checkpoints and the recipe's `mesh=`, on 2 and 4 gloo ranks
(`tests/torch_ranks.py`; what a rank runs is `tests/torch_train_ranks.py`,
which imports no jax) against the JAX package's sharded step on its
8-device CPU mesh, in the pytest process.

* layouts `data=2`, `model=2` (2 ranks) and `data=2 × model=2` (4 ranks,
  with remat), and `model=4` over 2 heads (4 ranks: q, k and v gathered);
  the port's flash (its plain twins) on where `model` is 1, off
  elsewhere, as JAX's own sharded tests run it, JAX's always off; with
  and without hard negatives;
* one step: loss and accuracy at rtol 1e-5, every gradient gathered whole
  at `STEP_TOL`; four steps with a clip that fires: parameters within 1%
  of Σ lr, the key bias within Σ lr (`test_torch_train.py`'s rules);
* `info_nce_loss(axis_name="data")` against JAX's under `shard_map`;
* `train_retriever` on data=2 against JAX's with `MeshSpec(data=2)`
  (equal metrics lines), its checkpoint resumed on one device, a one-device
  checkpoint resumed on model=2, the recipe on data=2 against one device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rag_dpo_tpu.models import BgeM3Config as JBgeM3Config
from rag_dpo_tpu.models import EncoderConfig as JEncoderConfig
from rag_dpo_tpu.parallel import MeshSpec as JMeshSpec
from rag_dpo_tpu.parallel import create_mesh as j_create_mesh
from rag_dpo_tpu.train import TrainConfig as JTrainConfig
from rag_dpo_tpu.train import create_train_state as j_create_train_state
from rag_dpo_tpu.train import make_sharded_train_step as j_make_sharded_step
from rag_dpo_tpu.train.contrastive import info_nce_loss as j_info_nce_loss
from rag_dpo_tpu.train.loop import LoopConfig as JLoopConfig
from rag_dpo_tpu.train.loop import train_retriever as j_train_retriever
from rag_dpo_tpu_torch.evals.train_encoder import train_eval_encoder
from rag_dpo_tpu_torch.models.convert import (
    flax_to_state_dict,
    load_params_npz,
)
from rag_dpo_tpu_torch.models.bge_m3 import full_flax_tree
from rag_dpo_tpu_torch.train.contrastive import learning_rate_at
from rag_dpo_tpu_torch.train.loop import train_retriever
from test_torch_train import STEP_TOL, _jax_loss_fn
from torch_ranks import run_ranks
from torch_train_ranks import (
    LAYOUTS,
    LOOP,
    NEGATIVES,
    PAIRS,
    RECIPE,
    STEPS,
    encoder_kw,
    info_nce_inputs,
    layout_spec,
    loop_config,
    loop_train_config,
    make_batch,
    metrics_lines,
    port_config,
    train_kw,
)

BATCH_SEED, INFO_SEED = 4, 9
CASES = [(layout, negatives) for world in LAYOUTS
         for layout, _ in LAYOUTS[world] for negatives in (False, True)]
CASE_IDS = [f"{layout}-{'hard-negatives' if n else 'in-batch'}"
            for layout, n in CASES]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads in the pytest process (see
    `test_torch_train.py`); each rank runs one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _world(layout: str) -> int:
    return next(w for w, names in LAYOUTS.items()
                if layout in dict(names))


def _jax_config(layout: str) -> JTrainConfig:
    """The layout's config in JAX, always on the reference attention and
    without remat (neither changes the values: its Pallas flash in
    interpret mode under a sharded jit compiles for tens of seconds, and
    `test_torch_train.py` holds the flash path to JAX's)."""
    kw = dict(encoder_kw(layout), use_flash_attention=False, remat=False)
    return JTrainConfig(model=JBgeM3Config(
        encoder=JEncoderConfig(**kw), colbert_dim=16), **train_kw())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lr_sum(steps: int, start: int = 0) -> float:
    cfg = port_config("data2")
    return sum(learning_rate_at(cfg, c) for c in range(start, steps))


def _assert_params_close(got: dict, want: dict, lr_sum: float):
    """`test_torch_train.py::test_four_steps_match_optax`'s rule: Adam
    moves a weight up to ~Σ lr whatever its gradient's size, so 1% of that
    travel bounds the frameworks' differences; the key bias, whose
    gradient is 0 in exact arithmetic, only Σ lr."""
    assert got.keys() == want.keys()
    for name, value in got.items():
        tol = (dict(atol=lr_sum, rtol=0) if name.endswith("key.bias")
               else dict(atol=0.01 * lr_sum, rtol=1e-5))
        np.testing.assert_allclose(value, want[name], err_msg=name, **tol)


@pytest.fixture(scope="module")
def params():
    """JAX's init of the tiny config: seed 1 for the layouts' steps, seed
    0 for the loop (JAX's `train_retriever` makes its state at seed 0)."""
    jcfg = _jax_config("data2")
    return (_np(j_create_train_state(jcfg, 1).params),
            _np(j_create_train_state(jcfg, 0).params))


@pytest.fixture(scope="module")
def root(tmp_path_factory, params):
    """A directory every rank sees, holding the one-device checkpoint at
    step 2 that the 2-rank run resumes on model=2."""
    path = tmp_path_factory.mktemp("sharded_train")
    train_retriever(PAIRS, loop_train_config(), "cpu", path / "single",
                    loop_config(2), negatives=NEGATIVES, params=params[1])
    return path


@pytest.fixture(scope="module")
def spawned(params, root):
    """Each world's ranks, spawned once (`run_world`), by world."""
    from torch_train_ranks import run_world

    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_ranks(run_world, world, params[0], BATCH_SEED,
                                     INFO_SEED, str(root), params[1])
        return cache[world]

    return get


@pytest.fixture(scope="module")
def jax_steps(params, eight_devices):
    """JAX's sharded step on each layout's mesh, `STEPS` steps (losses,
    accuracies, the last parameters), and the first step's gradients of
    its loss (`jax.value_and_grad` of `make_sharded_train_step`'s loss on
    the same parameters and batch, by head count: the layouts compute
    one function)."""
    cache, grads = {}, {}

    def get(layout, negatives):
        if (layout, negatives) not in cache:
            jcfg = _jax_config(layout)
            batch = {k: jnp.asarray(v)
                     for k, v in make_batch(BATCH_SEED, negatives).items()}
            mesh = j_create_mesh(JMeshSpec(**layout_spec(layout)))
            step, state = j_make_sharded_step(
                jcfg, mesh, j_create_train_state(jcfg, 1))
            losses, accs = [], []
            for _ in range(STEPS):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                accs.append(float(m["accuracy"]))
            heads = encoder_kw(layout)["num_heads"]
            if (heads, negatives) not in grads:
                _, g = jax.jit(jax.value_and_grad(
                    _jax_loss_fn(jcfg), has_aux=True))(params[0], batch)
                grads[heads, negatives] = flax_to_state_dict(_np(g))
            cache[layout, negatives] = {
                "loss": losses, "accuracy": accs,
                "params": flax_to_state_dict(_np(state.params)),
                "grads": grads[heads, negatives]}
        return cache[layout, negatives]

    return get


@pytest.mark.parametrize("layout,negatives", CASES, ids=CASE_IDS)
def test_one_step_matches_jax(spawned, jax_steps, layout, negatives):
    ranks = spawned(_world(layout))
    want = jax_steps(layout, negatives)
    model = layout_spec(layout).get("model", 1)
    for res in ranks:
        out = res["layouts"][layout, negatives]
        assert out["query_shape"] == (32 // model, 32)   # really split
        heads = encoder_kw(layout)["num_heads"]
        assert out["heads"] == (heads // model if heads % model == 0
                                else heads)
        assert out["loss"][0] == pytest.approx(want["loss"][0], rel=1e-5)
        assert out["accuracy"][0] == pytest.approx(want["accuracy"][0])
        assert out["grads"].keys() == want["grads"].keys()
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g, want["grads"][name], err_msg=name,
                                       **STEP_TOL)
    # the dense-only loss leaves the heads without gradient, as in JAX
    assert not ranks[0]["layouts"][layout, negatives]["grads"][
        "colbert_head.weight"].any()


@pytest.mark.parametrize("layout,negatives", CASES, ids=CASE_IDS)
def test_four_steps_with_a_firing_clip_match_jax(spawned, jax_steps, layout,
                                                 negatives):
    ranks = spawned(_world(layout))
    want = jax_steps(layout, negatives)
    norm = np.sqrt(sum(float((g * g).sum())
                       for g in want["grads"].values()))
    assert norm > train_kw()["grad_clip"]            # the clip fired
    for res in ranks:
        out = res["layouts"][layout, negatives]
        assert out["step"] == STEPS
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["accuracy"], want["accuracy"])
        _assert_params_close(out["params"], want["params"], _lr_sum(STEPS))


@pytest.mark.parametrize("negatives", [False, True],
                         ids=["in-batch", "hard-negatives"])
def test_info_nce_over_data_matches_jax_shard_map(spawned, eight_devices,
                                                  negatives):
    """Global negatives over data=2: loss, accuracy and the gradients of
    this rank's q, p and negatives equal JAX's under `shard_map`, where
    the transpose of its all-gather sums every rank's gradient."""
    q, p, n, valid = info_nce_inputs(INFO_SEED)
    mesh = j_create_mesh(JMeshSpec(data=2))
    spec = P("data")

    def loss_fn(q, p, n):
        def inner(q, p, n, v):
            kw = dict(n_emb=n, n_valid=v) if negatives else {}
            return j_info_nce_loss(q, p, 0.05, "data", **kw)

        return jax.shard_map(inner, mesh=mesh, in_specs=(spec,) * 4,
                             out_specs=(P(), P()))(q, p, n, jnp.asarray(valid))

    (loss, acc), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(q, p, n)
    ranks = [r["info_nce"][negatives] for r in spawned(2)]
    for rank, out in enumerate(ranks):
        assert out["loss"] == pytest.approx(float(loss), rel=1e-6)
        assert out["accuracy"] == pytest.approx(float(acc))
    for i, name in enumerate(("dq", "dp", "dn")):
        if name == "dn" and not negatives:
            continue
        got = np.concatenate([out[name] for out in ranks])
        np.testing.assert_allclose(got, np.asarray(grads[i]), atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    if not negatives:
        assert not np.asarray(grads[2]).any()


@pytest.fixture(scope="module")
def one_device(root, params):
    """The loop on one device, uninterrupted: 4 steps, then resumed from
    its own checkpoint to 6 (the parameters at both)."""
    cfg, tree = loop_train_config(), params[1]
    state = train_retriever(PAIRS, cfg, "cpu", root / "one", loop_config(4),
                            metrics_path=root / "one.jsonl",
                            negatives=NEGATIVES, params=tree)
    at4 = flax_to_state_dict(full_flax_tree(state.model))
    state = train_retriever(PAIRS, cfg, "cpu", root / "one", loop_config(6),
                            metrics_path=root / "one.jsonl",
                            negatives=NEGATIVES, params=tree)
    return at4, flax_to_state_dict(full_flax_tree(state.model))


def test_train_retriever_on_two_ranks_matches_jax(spawned, root, tmp_path,
                                                  eight_devices):
    """The same batches (`PairBatcher.batch_at` on every rank), JAX's
    init: the metrics lines of the first rank equal JAX's."""
    for res in spawned(2):
        assert res["loop"]["mesh_step"] == 4
    jcfg = _jax_config("data2")
    j_train_retriever(PAIRS, jcfg, j_create_mesh(JMeshSpec(data=2)),
                      tmp_path / "ckpt", JLoopConfig(max_steps=4, **LOOP),
                      metrics_path=tmp_path / "jax.jsonl",
                      negatives=NEGATIVES)
    got, want = (metrics_lines(root / "mesh_metrics.jsonl")[:4],
                 metrics_lines(tmp_path / "jax.jsonl"))
    assert [e["step"] for e in got] == [e["step"] for e in want] \
        == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert g["accuracy"] == w["accuracy"]
        assert g["loss"] == pytest.approx(w["loss"], abs=2e-5)


def test_mesh_checkpoint_resumes_on_one_device(spawned, root, params,
                                               one_device):
    """The data=2 run's step-4 checkpoint (the whole state, written by
    the first rank) resumed on one device to step 6 trains as the
    uninterrupted one-device run does."""
    spawned(2)
    state = train_retriever(PAIRS, loop_train_config(), "cpu", root / "mesh",
                            loop_config(6),
                            metrics_path=root / "mesh_metrics.jsonl",
                            negatives=NEGATIVES, params=params[1])
    assert state.step == 6
    got = metrics_lines(root / "mesh_metrics.jsonl")
    want = metrics_lines(root / "one.jsonl")
    assert [e["step"] for e in got] == [e["step"] for e in want]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], abs=2e-5)
    _assert_params_close(flax_to_state_dict(full_flax_tree(state.model)),
                         one_device[1], _lr_sum(6))


def test_one_device_checkpoint_resumes_on_the_model_axis(spawned, root,
                                                         one_device):
    """The one-device checkpoint at step 2 resumed on model=2 (each rank
    cuts its slices of the whole state) to step 4: the parameters,
    gathered whole, and the metrics of steps 3-4 are the uninterrupted
    run's."""
    for res in spawned(2):
        assert res["loop"]["resumed_step"] == 4
        _assert_params_close(res["loop"]["resumed_params"], one_device[0],
                             _lr_sum(4))
    got = metrics_lines(root / "resumed_metrics.jsonl")
    want = metrics_lines(root / "one.jsonl")[2:4]
    assert [e["step"] for e in got] == [e["step"] for e in want] == [3, 4]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], abs=2e-5)


def test_recipe_on_a_mesh_matches_one_device(spawned, root):
    """`train_eval_encoder(mesh=)` on data=2: the first rank's npz, the
    model gathered whole, and every rank's numbers equal the one-device
    recipe's."""
    ranks = spawned(2)
    want = train_eval_encoder(root / "recipe_one.npz", device="cpu",
                              **RECIPE)
    for res in ranks:
        got = res["loop"]["recipe"]
        assert got["n_pairs"] == want["n_pairs"]
        for key in ("loss_first", "loss_last"):
            assert got[key] == pytest.approx(want[key], abs=2e-5), key
    cfg = dataclasses.replace(port_config("data2"), learning_rate=3e-4,
                              warmup_steps=20)
    lr_sum = sum(learning_rate_at(cfg, c) for c in range(RECIPE["steps"]))
    mesh_npz = load_params_npz(root / "recipe_mesh.npz")
    one_npz = load_params_npz(root / "recipe_one.npz")
    got, want = flax_to_state_dict(mesh_npz), flax_to_state_dict(one_npz)
    assert got.keys() == want.keys()
    for name, value in got.items():
        np.testing.assert_allclose(value, want[name], atol=lr_sum, rtol=0,
                                   err_msg=name)
