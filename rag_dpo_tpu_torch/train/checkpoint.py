"""Training checkpoint/resume with `torch.save`.

Port of `rag_dpo_tpu/train/checkpoint.py` with the same API. The reference
writes orbax checkpoints; the port writes one `<step>.pt` file per step
holding the step, the model's state dict (every head included) and the
optimizer's, because orbax is JAX's and the port runs where JAX is not
installed (a deliberate divergence, ROADMAP C-9). Weights to share with the
JAX package go through `models.convert.save_params_npz` instead.

As JAX's orbax checkpoint holds global arrays, a file does not depend on
the layout that wrote it: a mesh state (`TrainState.mesh`) saves the WHOLE
model and Adam moments, its TP slices gathered over the model axis, from
the first rank, and a mesh restore cuts this rank's slices. So a mesh
checkpoint resumes on one device and the reverse. On a mesh every rank
calls `save` and `restore`, and the directory is one every rank sees.
"""

from __future__ import annotations

import os
import pathlib

import torch
import torch.distributed as dist

from ..models.sharding import TensorParallel, gather_state, slice_state
from ..parallel.mesh import AXIS_DATA, AXIS_SHARD, axis_index
from .contrastive import (
    TrainState,
    gather_optimizer_state,
    slice_optimizer_state,
)


def _param_names(state: TrainState) -> list:
    return [n for n, _ in state.model.named_parameters()]


def _whole_payload(state: TrainState) -> dict | None:
    """The step, model and optimizer of a state as one device holds them:
    on a mesh, gathered over the model axis by the ranks at data and
    shard coordinate 0 (the others hold replicas, gather nothing and get
    None), and moved to the host."""
    mesh = state.mesh
    model = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    if mesh is not None:
        if axis_index(mesh, (AXIS_DATA, AXIS_SHARD)) != 0:
            return None
        tp = TensorParallel.of(mesh)
        model = gather_state(model, tp)
        optimizer = gather_optimizer_state(optimizer, _param_names(state),
                                           tp)
        model = {k: v.cpu() for k, v in model.items()}
        optimizer["state"] = {i: {k: v.cpu() for k, v in m.items()}
                              for i, m in optimizer["state"].items()}
    return {"step": int(state.step), "model": model, "optimizer": optimizer}


class TrainCheckpointer:
    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = pathlib.Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> pathlib.Path:
        return self.directory / f"{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

    def save(self, state: TrainState, *, force: bool = False) -> bool:
        """Write the state at its step; False (nothing written) when a
        checkpoint at that step or a later one exists, unless `force`.
        Keeps the newest `max_to_keep` checkpoints. On a mesh, every rank
        reads the directory before the first rank writes, and returns
        once the file is there."""
        step = int(state.step)
        latest = self.latest_step()
        on_mesh = state.mesh is not None
        if on_mesh:
            dist.barrier()
        if latest is not None and step <= latest and not force:
            return False
        payload = _whole_payload(state)
        if not on_mesh or dist.get_rank() == 0:
            path = self._path(step)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.max_to_keep]:
                self._path(old).unlink()
        if on_mesh:
            dist.barrier()
        return True

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState,
                step: int | None = None) -> TrainState:
        """Load a checkpoint (the latest by default) into `template`, in
        place, onto the device of its model; returns it. A mesh template
        takes its rank's slices of the whole state."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(template.model.parameters()).device
        mesh = template.mesh
        payload = torch.load(self._path(step),
                             map_location="cpu" if mesh else device,
                             weights_only=True)
        model, optimizer = payload["model"], payload["optimizer"]
        if mesh is not None:
            tp = TensorParallel.of(mesh)
            model = slice_state(model, tp)
            optimizer = slice_optimizer_state(
                optimizer, _param_names(template), tp)
        template.model.load_state_dict(model)
        template.optimizer.load_state_dict(optimizer)
        template.step = int(payload["step"])
        return template

    def close(self):
        """Nothing to release: every save is written before it returns."""
