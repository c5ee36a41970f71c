"""Training checkpoint/resume with `torch.save`.

Port of `rag_dpo_tpu/train/checkpoint.py` with the same API. The reference
writes orbax checkpoints; the port writes one `<step>.pt` file per step
holding the step, the model's state dict (every head included) and the
optimizer's, because orbax is JAX's and the port runs where JAX is not
installed (a deliberate divergence, ROADMAP C-9). Weights to share with the
JAX package go through `models.convert.save_params_npz` instead.
"""

from __future__ import annotations

import os
import pathlib

import torch

from .contrastive import TrainState


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
        Keeps the newest `max_to_keep` checkpoints."""
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and step <= latest and not force:
            return False
        path = self._path(step)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({"step": step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink()
        return True

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState,
                step: int | None = None) -> TrainState:
        """Load a checkpoint (the latest by default) into `template`, in
        place, onto the device of its model; returns it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(template.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        template.model.load_state_dict(payload["model"])
        template.optimizer.load_state_dict(payload["optimizer"])
        template.step = int(payload["step"])
        return template

    def close(self):
        """Nothing to release: every save is written before it returns."""
