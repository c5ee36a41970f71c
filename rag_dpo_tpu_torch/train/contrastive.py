"""Contrastive training of the retriever encoder on one torch device.

Port of `rag_dpo_tpu/train/contrastive.py`: in-batch-negative InfoNCE
fine-tuning of the BGE-M3 encoder on (query, positive passage) pairs, with
optional mined hard negatives, and the reference's optimizer —
`optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))` —
reproduced step for step by `ClipAdamW`.

The loss runs a dense-only forward (`BgeM3Model(dense_only=True)`), as the
reference's step builds a dense-only model over the unchanged parameter
tree: the sparse and ColBERT heads stay in the model and its checkpoints,
get zero gradients, and are still decayed by AdamW, as optax decays them.

One device: the in-batch negatives are the device's batch. DDP with global
negatives is the multi-GPU slice; an `axis_name` or a mesh of more than one
device raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.nn import functional as F

from ..models import BgeM3Config, BgeM3Model
from ..models.bge_m3 import build_bge_m3
from ..ops import default_device

DECAY_STEPS = 10_000  # the reference schedule's total length
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults
_MULTI_DEVICE = ("global in-batch negatives across devices (DDP) belong to "
                 "the multi-GPU slice: ROADMAP Queue A item 9")


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
    step: int
    model: BgeM3Model
    optimizer: "ClipAdamW"


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
    `state_dict()`."""

    def __init__(self, params, schedule, grad_clip: float,
                 weight_decay: float):
        super().__init__(params, dict(weight_decay=weight_decay,
                                      grad_clip=grad_clip, count=0))
        self.schedule = schedule

    @torch.no_grad()
    def step(self):
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
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


def make_optimizer(cfg: TrainConfig, params) -> ClipAdamW:
    return ClipAdamW(params, lambda count: learning_rate_at(cfg, count),
                     cfg.grad_clip, cfg.weight_decay)


def create_train_state(cfg: TrainConfig, rng_seed: int = 0, device=None,
                       params=None) -> TrainState:
    """Step 0, the model on `device` (the given Flax tree, else seeded
    random weights), and a fresh optimizer."""
    model = build_bge_m3(cfg.model, params, rng_seed,
                         default_device(device)).train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model.parameters()))


def info_nce_loss(q_emb, p_emb, temperature: float,
                  axis_name: str | None = None, n_emb=None, n_valid=None):
    """Bidirectional InfoNCE over in-batch negatives, plus optional
    explicit hard negatives. → (loss, accuracy), f32 scalars.

    q_emb/p_emb: [B, H] L2-normalized. n_emb: [B, H], one mined negative
    passage per query, appended as a shared pool of extra columns of the
    query→passage softmax only; n_valid: [B] bool, rows without a mined
    negative mask their column to −1e30 for every query."""
    if axis_name is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    labels = torch.arange(q_emb.shape[0], device=q_emb.device)
    logits = q_emb @ p_emb.T / temperature
    if n_emb is not None:
        neg = q_emb @ n_emb.T / temperature
        if n_valid is not None:
            neg = torch.where(n_valid.to(neg.device)[None, :], neg, -1e30)
        logits = torch.cat([logits, neg], dim=1)
    loss_q = F.cross_entropy(logits, labels, reduction="none")
    loss_p = F.cross_entropy(p_emb @ q_emb.T / temperature, labels,
                             reduction="none")
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return (loss_q + loss_p).mean() / 2, acc


def contrastive_loss(model: BgeM3Model, batch: dict, temperature: float):
    """The reference step's loss on one batch → (loss, accuracy)."""
    dev = next(model.parameters()).device
    b = {k: v.to(dev) for k, v in batch.items()}

    def dense(prefix):  # in the encoder's dtype, as JAX's loss takes it
        return model(b[f"{prefix}_ids"], b[f"{prefix}_lengths"],
                     dense_only=True).dense

    q_emb, p_emb = dense("query"), dense("passage")
    n_emb = n_valid = None
    if "negative_ids" in b:
        n_emb, n_valid = dense("negative"), b["negative_valid"]
    return info_nce_loss(q_emb, p_emb, temperature, n_emb=n_emb,
                         n_valid=n_valid)


def make_train_step(cfg: TrainConfig, state: TrainState,
                    axis_name: str | None = None, mesh=None):
    """→ step(state, batch) → (state, {"loss", "accuracy"}) on one device.

    The step updates the state's model and optimizer in place and returns
    the same state, its step advanced. The metrics are device scalars
    (reading them synchronises). `mesh`: a `torch.distributed.DeviceMesh`;
    one of more than one device, or an `axis_name`, raises."""
    if axis_name is not None or (mesh is not None and mesh.size() > 1):
        raise NotImplementedError(_MULTI_DEVICE)

    def step_fn(state: TrainState, batch: dict):
        state.model.train()
        loss, acc = contrastive_loss(state.model, batch, cfg.temperature)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": acc.detach()}

    return step_fn
