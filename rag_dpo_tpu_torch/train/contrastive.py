"""Contrastive training of the retriever encoder, on one device or a mesh.

Port of `rag_dpo_tpu/train/contrastive.py`: in-batch-negative InfoNCE
fine-tuning of the BGE-M3 encoder on (query, positive passage) pairs, with
optional mined hard negatives, and the reference's optimizer —
`optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))` —
reproduced step for step by `ClipAdamW`.

The loss runs a dense-only forward (`BgeM3Model(dense_only=True)`), as the
reference's step builds a dense-only model over the unchanged parameter
tree: the sparse and ColBERT heads stay in the model and its checkpoints,
get zero gradients, and are still decayed by AdamW, as optax decays them.

`make_train_step` is the step on one device. `make_sharded_train_step` is
JAX's step on a `DeviceMesh` (one process a device):

* data parallel over `data`: each rank takes its rows of the global batch,
  and the in-batch negatives are global — queries, positives and mined
  negatives all-gathered over `data` with a gradient
  (`parallel.collectives.all_gather`), labels offset by the rank's
  coordinate, loss and accuracy the mean over `data` — so the loss and
  the update are the one-device step's on the whole batch;
* tensor parallel over `model`: the encoder holds this rank's slices under
  JAX's `_COL` / `_ROW` rules (`models/sharding.py`, `models/encoder.py`);
* gradients summed over `data` (the loss's mean over `data` carries the
  1/|data|), never over `model`; the clip's norm is the whole tree's, the
  TP-split leaves' squares summed over `model` and the replicated ones
  counted once. Adam and weight decay are elementwise, so they run on the
  slices as they are.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.nn import functional as F

from ..models import BgeM3Config, BgeM3Model
from ..models.bge_m3 import build_bge_m3
from ..models.sharding import (
    TensorParallel,
    gather_entry,
    slice_entry,
    slice_state,
    split_axis,
)
from ..ops import default_device
from ..parallel.collectives import all_gather, gather_rows, pmean, sum_grads
from ..parallel.mesh import AXIS_DATA, AxisGroup, mesh_device, \
    shard_leading_axis

DECAY_STEPS = 10_000  # the reference schedule's total length
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: BgeM3Config
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    temperature: float = 0.05
    warmup_steps: int = 100
    grad_clip: float = 1.0


@dataclasses.dataclass
class TrainState:
    """`mesh`: the `DeviceMesh` a sharded step runs on (its model holds
    this rank's TP slices), None on one device."""
    step: int
    model: BgeM3Model
    optimizer: "ClipAdamW"
    mesh: object = None


def learning_rate_at(cfg: TrainConfig, count: int) -> float:
    """`optax.warmup_cosine_decay_schedule(0, lr, warmup, 10_000)(count)`:
    linear from 0 over the warmup, then cosine decay to 0."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    if count < warmup:
        return -peak * (1.0 - count / warmup) + peak
    span = DECAY_STEPS - warmup
    t = min(count - warmup, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))


class ClipAdamW(torch.optim.Optimizer):
    """`optax.chain(clip_by_global_norm(clip), adamw(schedule,
    weight_decay))` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8),
    step for step, over one parameter group:

    * the gradient of every parameter counts, a missing one as zeros;
    * clip: scale by clip/‖g‖ only when ‖g‖ ≥ clip (no epsilon, unlike
      `torch.nn.utils.clip_grad_norm_`);
    * AdamW: m̂/(√v̂ + eps) + wd·p for every parameter, biases and
      LayerNorm included, times −lr;
    * the schedule is read at the update count *before* the update, so
      the first step's learning rate is `schedule(0)` (0 here).

    The update count lives in the parameter group and so in
    `state_dict()`.

    On a mesh (`tp` and `split`: the model axis and, per parameter,
    whether the TP rules split it) the parameters are this rank's slices:
    the clip's norm is still the whole tree's, the split leaves' squares
    summed over the model axis and the replicated leaves counted once."""

    def __init__(self, params, schedule, grad_clip: float,
                 weight_decay: float, tp=None, split=None):
        super().__init__(params, dict(weight_decay=weight_decay,
                                      grad_clip=grad_clip, count=0))
        self.schedule = schedule
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.split = split

    def _global_norm(self, grads):
        norms = torch.stack(torch._foreach_norm(grads))
        if self.tp is None:
            return torch.linalg.vector_norm(norms)
        sq = norms.double() ** 2
        mask = torch.tensor(self.split, device=sq.device)
        part = sq[mask].sum().reshape(1)
        dist.all_reduce(part, group=self.tp.group)
        return torch.sqrt(part[0] + sq[~mask].sum()).to(norms.dtype)

    @torch.no_grad()
    def step(self):
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = self._global_norm(grads)
        clip = group["grad_clip"]
        grads = torch._foreach_mul(
            grads, torch.where(norm < clip, torch.ones_like(norm),
                               clip / norm))

        lr = float(self.schedule(group["count"]))
        group["count"] += 1
        count = group["count"]
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, grads, alpha=1 - _B1)
        torch._foreach_mul_(nu, _B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - _B2)
        del grads
        denom = torch._foreach_div(nu, 1 - _B2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        upd = torch._foreach_div(mu, 1 - _B1 ** count)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, upd, alpha=-lr)


def make_optimizer(cfg: TrainConfig, params, tp=None,
                   split=None) -> ClipAdamW:
    return ClipAdamW(params, lambda count: learning_rate_at(cfg, count),
                     cfg.grad_clip, cfg.weight_decay, tp, split)


def create_train_state(cfg: TrainConfig, rng_seed: int = 0, device=None,
                       params=None) -> TrainState:
    """Step 0, the model on `device` (the given Flax tree, else seeded
    random weights), and a fresh optimizer."""
    model = build_bge_m3(cfg.model, params, rng_seed,
                         default_device(device)).train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model.parameters()))


def info_nce_loss(q_emb, p_emb, temperature: float,
                  axis_name: str | None = None, n_emb=None, n_valid=None,
                  mesh=None):
    """Bidirectional InfoNCE over in-batch negatives, plus optional
    explicit hard negatives. → (loss, accuracy), f32 scalars.

    q_emb/p_emb: [B, H] L2-normalized. n_emb: [B, H], one mined negative
    passage per query, appended as a shared pool of extra columns of the
    query→passage softmax only; n_valid: [B] bool, rows without a mined
    negative mask their column to −1e30 for every query.

    `axis_name`, an axis of `mesh`: the rows are this rank's, and q, p,
    the negatives and `n_valid` are all-gathered over the axis, so every
    rank scores against the global batch; labels are offset by the rank's
    coordinate, and loss and accuracy are averaged over the axis."""
    ax = None
    if axis_name is not None:
        if mesh is None:
            raise ValueError(f"axis_name={axis_name!r} names an axis of a "
                             "mesh: pass mesh=")
        ax = AxisGroup.of(mesh, axis_name)
    q_all, p_all = all_gather(q_emb, ax), all_gather(p_emb, ax)
    offset = 0 if ax is None else ax.rank * q_emb.shape[0]
    labels = torch.arange(q_emb.shape[0], device=q_emb.device) + offset
    logits = q_emb @ p_all.T / temperature
    if n_emb is not None:
        neg = q_emb @ all_gather(n_emb, ax).T / temperature
        if n_valid is not None:
            valid = gather_rows(n_valid.to(neg.device), ax)
            neg = torch.where(valid[None, :], neg, -1e30)
        logits = torch.cat([logits, neg], dim=1)
    loss_q = F.cross_entropy(logits, labels, reduction="none")
    loss_p = F.cross_entropy(p_emb @ q_all.T / temperature, labels,
                             reduction="none")
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return pmean((loss_q + loss_p).mean() / 2, ax), pmean(acc, ax)


def contrastive_loss(model: BgeM3Model, batch: dict, temperature: float,
                     mesh=None):
    """The reference step's loss on one batch → (loss, accuracy). With
    `mesh`, the batch is this rank's rows on `data` and the negatives are
    global (`info_nce_loss(axis_name="data")`)."""
    dev = next(model.parameters()).device
    b = {k: v.to(dev) for k, v in batch.items()}

    def dense(prefix):  # in the encoder's dtype, as JAX's loss takes it
        return model(b[f"{prefix}_ids"], b[f"{prefix}_lengths"],
                     dense_only=True).dense

    q_emb, p_emb = dense("query"), dense("passage")
    n_emb = n_valid = None
    if "negative_ids" in b:
        n_emb, n_valid = dense("negative"), b["negative_valid"]
    return info_nce_loss(q_emb, p_emb, temperature,
                         AXIS_DATA if mesh is not None else None,
                         n_emb=n_emb, n_valid=n_valid, mesh=mesh)


def _apply_step(cfg: TrainConfig, state: TrainState, batch: dict,
                mesh=None) -> dict:
    state.model.train()
    loss, acc = contrastive_loss(state.model, batch, cfg.temperature, mesh)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        sum_grads(state.model.parameters(), AxisGroup.of(mesh, AXIS_DATA))
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach(), "accuracy": acc.detach()}


def make_train_step(cfg: TrainConfig, state: TrainState):
    """→ step(state, batch) → (state, {"loss", "accuracy"}) on one device.

    The step updates the state's model and optimizer in place and returns
    the same state, its step advanced. The metrics are device scalars
    (reading them synchronises). On a mesh: `make_sharded_train_step`."""

    def step_fn(state: TrainState, batch: dict):
        return state, _apply_step(cfg, state, batch)

    return step_fn


def slice_optimizer_state(full: dict, names: list, tp) -> dict:
    """A whole `ClipAdamW.state_dict()` → this rank's: each parameter's
    moments (parameter i is `names[i]`) cut as the parameter is."""
    return {**full, "state": {
        i: {k: slice_entry(names[i], v, tp) for k, v in moments.items()}
        for i, moments in full["state"].items()}}


def gather_optimizer_state(sliced: dict, names: list, tp) -> dict:
    """This rank's `ClipAdamW.state_dict()` → the whole one, every
    moment gathered over the model axis (every rank of the model group
    calls this)."""
    return {**sliced, "state": {
        i: {k: gather_entry(names[i], v, tp) for k, v in moments.items()}
        for i, moments in sliced["state"].items()}}


def _shard_train_state(cfg: TrainConfig, state: TrainState,
                       mesh) -> TrainState:
    """A whole (one-device) state → this rank's state on `mesh`: the model
    rebuilt from this rank's TP slices on the rank's device (the same
    model where `model` is 1 and it is there already), Adam's moments cut
    the same way, the update count kept."""
    tp = TensorParallel.of(mesh)
    dev = mesh_device(mesh)
    model = state.model
    if tp.size > 1 or next(model.parameters()).device != dev:
        with torch.device(dev):
            model = BgeM3Model(cfg.model, tp)
        model.load_state_dict(slice_state(state.model.state_dict(), tp))
    model.train()
    names = [n for n, _ in model.named_parameters()]
    optimizer = make_optimizer(cfg, model.parameters(), tp,
                               [split_axis(n) is not None for n in names])
    optimizer.load_state_dict(slice_optimizer_state(
        state.optimizer.state_dict(), names, tp))
    return TrainState(step=state.step, model=model, optimizer=optimizer,
                      mesh=mesh)


def make_sharded_train_step(cfg: TrainConfig, mesh, state: TrainState):
    """→ (step, sharded_state), JAX's signature: `state` (a whole state,
    e.g. `create_train_state`'s) becomes this rank's on `mesh`
    (`_shard_train_state`), and step(state, batch) → (state, {"loss",
    "accuracy"}) takes the GLOBAL batch and keeps this rank's rows on
    `data` (`parallel.mesh.shard_leading_axis`); with `local=True` the
    batch already holds them (e.g. from `host_local_rows`). Loss and
    accuracy are the global batch's, the same on every rank, and the
    update is the one-device step's on the whole batch."""
    sharded = _shard_train_state(cfg, state, mesh)

    def step_fn(state: TrainState, batch: dict, *, local: bool = False):
        if not local:       # a batch `data` does not divide raises here
            batch = {k: shard_leading_axis(mesh, v, AXIS_DATA)
                     for k, v in batch.items()}
        return state, _apply_step(cfg, state, batch, mesh)

    return step_fn, sharded
