"""What the sharded training tests (`tests/test_torch_train_sharded.py`)
run in each gloo rank: numpy and the port only, no jax, so a rank imports
what the card's machine has. Every function takes `(rank, world, ...)` for
`torch_ranks.run_ranks` and returns numpy results; the inputs are made
here from seeds, so both sides of a test build the same ones.
"""

import json
import pathlib

import numpy as np
import torch

LAYOUTS = {
    2: (("data2", dict(data=2)), ("model2", dict(model=2))),
    4: (("data2model2", dict(data=2, model=2)),
        ("model4-gather", dict(model=4))),
}
STEPS = 4
PAIRS = [(f"question sur le sujet {i} et ses suites",
          f"passage documentaire détaillant le sujet {i} et ses "
          f"obligations au titre {i % 5}") for i in range(16)]
NEGATIVES = [None if i % 3 == 0 else PAIRS[(i + 5) % 16][1]
             for i in range(16)]
LOOP = dict(batch_size=4, seq_len=16, checkpoint_every=2, log_every=1)
# the recipe's mesh run, short (mining hard negatives takes ~8 s a process)
RECIPE = dict(steps=2, batch_size=8, seq_len=32, log_every=1,
              hard_negatives=False)


def encoder_kw(layout: str) -> dict:
    """The tiny BGE-M3 of a layout: 4 heads and 2 layers; flash (its plain
    twins on the CPU) where `model` is 1, the reference path elsewhere, as
    JAX's sharded tests run it; the 4-rank data × model layout with remat
    (the TP collectives run again in the backward), the gather layout with
    2 heads over model=4."""
    spec = layout_spec(layout)
    return dict(vocab_size=256, hidden_size=32, num_layers=2,
                num_heads=2 if layout == "model4-gather" else 4,
                intermediate_size=64, max_position_embeddings=66,
                use_flash_attention=spec.get("model", 1) == 1,
                remat=layout == "data2model2")


def train_kw() -> dict:
    """lr 1e-3 after a 2-step warmup, a clip of 0.05 that fires."""
    return dict(warmup_steps=2, learning_rate=1e-3, grad_clip=0.05)


def layout_spec(layout: str) -> dict:
    return next(spec for world in LAYOUTS.values()
                for name, spec in world if name == layout)


def port_config(layout: str):
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.train import TrainConfig

    return TrainConfig(model=BgeM3Config(
        encoder=EncoderConfig(**encoder_kw(layout)), colbert_dim=16),
        **train_kw())


def make_batch(seed: int, negatives: bool, s: int = 12) -> dict:
    """4 rows of ragged ids (numpy int32), as `tests/test_torch_train.py`
    makes them; a masked negative in row 1."""
    rng = np.random.default_rng(seed)
    batch = {}
    for name, lens in (("query", [12, 5, 9, 3]), ("passage", [12, 12, 7, 10]),
                       ("negative", [11, 1, 12, 6])):
        if name == "negative" and not negatives:
            continue
        ids = np.full((len(lens), s), 1, np.int32)
        for i, n in enumerate(lens):
            ids[i, :n] = rng.integers(4, 256, size=n)
            ids[i, 0], ids[i, n - 1] = 0, 2
        batch[f"{name}_ids"] = ids
        batch[f"{name}_lengths"] = np.asarray(lens, np.int32)
    if negatives:
        batch["negative_valid"] = np.asarray([True, False, True, True])
    return batch


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k.endswith("_ids")
            else torch.from_numpy(v) for k, v in batch.items()}


def _whole(model, values: dict) -> dict:
    """name → numpy of a rank's tensors gathered over the model axis."""
    from rag_dpo_tpu_torch.models.sharding import gather_state

    return {k: v.detach().numpy().copy()
            for k, v in gather_state(values, model.tp).items()}


def _grads(model) -> dict:
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def sharded_steps(rank, world, layout: str, negatives: bool, params,
                  batch_seed: int) -> dict:
    """`STEPS` steps of `make_sharded_train_step` on the layout's mesh
    from the given Flax tree: each step's loss and accuracy, the first
    step's gradients and the last parameters, whole."""
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh
    from rag_dpo_tpu_torch.train import (
        create_train_state,
        make_sharded_train_step,
    )

    cfg = port_config(layout)
    mesh = create_mesh(MeshSpec(**layout_spec(layout)), device_type="cpu")
    step, state = make_sharded_train_step(
        cfg, mesh, create_train_state(cfg, params=params, device="cpu"))
    batch = to_torch(make_batch(batch_seed, negatives))
    out = {"loss": [], "accuracy": [],
           "query_shape": tuple(
               state.model.encoder.layer_0.attention.query.weight.shape),
           "heads": state.model.encoder.layer_0.attention.heads}
    for i in range(STEPS):
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["loss"]))
        out["accuracy"].append(float(metrics["accuracy"]))
        if i == 0:
            out["grads"] = _whole(state.model, _grads(state.model))
    out["params"] = _whole(state.model, dict(state.model.named_parameters()))
    out["step"] = state.step
    return out


def run_world(rank, world, params, batch_seed: int, info_seed: int,
              root: str, loop_params) -> dict:
    """One spawn a world: every layout of it with and without hard
    negatives from `params`; on 2 ranks also `info_nce` with and without
    negatives and `loop_and_checkpoints` from `loop_params`."""
    out = {"layouts": {(layout, negatives): sharded_steps(
        rank, world, layout, negatives, params, batch_seed)
        for layout, _ in LAYOUTS[world] for negatives in (False, True)}}
    if world == 2:
        out["info_nce"] = {negatives: info_nce(rank, world, info_seed,
                                               negatives)
                           for negatives in (False, True)}
        out["loop"] = loop_and_checkpoints(rank, world, root, loop_params)
    return out


def info_nce(rank, world, seed: int, negatives: bool) -> dict:
    """`info_nce_loss(axis_name="data")` over data=world: this rank's rows
    of the seeded embeddings; loss, accuracy and their gradients for this
    rank's q, p and negatives."""
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh
    from rag_dpo_tpu_torch.train.contrastive import info_nce_loss

    mesh = create_mesh(MeshSpec(data=world), device_type="cpu")
    q, p, n, valid = info_nce_inputs(seed)
    per = q.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    tq, tp, tn = (torch.from_numpy(x[rows]).requires_grad_()
                  for x in (q, p, n))
    kw = dict(n_emb=tn, n_valid=torch.from_numpy(valid[rows])) \
        if negatives else {}
    loss, acc = info_nce_loss(tq, tp, 0.05, axis_name="data", mesh=mesh,
                              **kw)
    loss.backward()
    return {"loss": float(loss), "accuracy": float(acc),
            "dq": tq.grad.numpy(), "dp": tp.grad.numpy(),
            "dn": tn.grad.numpy() if negatives else None}


def info_nce_inputs(seed: int):
    rng = np.random.default_rng(seed)
    q, p, n = (rng.standard_normal((8, 16)).astype(np.float32)
               for _ in range(3))
    q, p, n = (x / np.linalg.norm(x, axis=1, keepdims=True)
               for x in (q, p, n))
    p[3] = q[5]                  # a row that scores another's query best
    valid = np.asarray([True, False, True, True, False, True, True, True])
    return q, p, n, valid


def loop_config(max_steps: int):
    from rag_dpo_tpu_torch.train.loop import LoopConfig

    return LoopConfig(max_steps=max_steps, **LOOP)


def loop_train_config():
    from rag_dpo_tpu_torch.models import BgeM3Config, EncoderConfig
    from rag_dpo_tpu_torch.train import TrainConfig

    return TrainConfig(model=BgeM3Config(encoder=EncoderConfig(
        **encoder_kw("data2")), colbert_dim=16), **train_kw())


def loop_and_checkpoints(rank, world, root: str, params: dict) -> dict:
    """On 2 ranks: `train_retriever` on data=2 for 4 steps from `params`
    (checkpoints at 2 and 4) into `root/mesh`; then the one-device
    checkpoint at step 2 under `root/single` resumed on model=2 to step 4;
    then the recipe on data=2."""
    from rag_dpo_tpu_torch.evals.train_encoder import train_eval_encoder
    from rag_dpo_tpu_torch.models.bge_m3 import full_flax_tree
    from rag_dpo_tpu_torch.models.convert import flax_to_state_dict
    from rag_dpo_tpu_torch.parallel import MeshSpec, create_mesh
    from rag_dpo_tpu_torch.train.loop import train_retriever

    root = pathlib.Path(root)
    cfg = loop_train_config()
    data = create_mesh(MeshSpec(data=2), device_type="cpu")
    state = train_retriever(PAIRS, cfg, data, root / "mesh", loop_config(4),
                            metrics_path=root / "mesh_metrics.jsonl",
                            negatives=NEGATIVES, params=params)
    out = {"mesh_step": state.step}
    # the one-device checkpoint at step 2, resumed with the model axis
    model = create_mesh(MeshSpec(model=2), device_type="cpu")
    state = train_retriever(PAIRS, cfg, model, root / "single",
                            loop_config(4),
                            metrics_path=root / "resumed_metrics.jsonl",
                            negatives=NEGATIVES, params=params)
    out["resumed_step"] = state.step
    out["resumed_params"] = flax_to_state_dict(full_flax_tree(state.model))
    out["recipe"] = train_eval_encoder(root / "recipe_mesh.npz", mesh=data,
                                       **RECIPE)
    return out


def metrics_lines(path) -> list:
    return [json.loads(line) for line in
            pathlib.Path(path).read_text().splitlines()]
