"""Parameter sharding rules for tensor parallelism (Megatron layout).

Port of `rag_dpo_tpu/models/sharding.py`, with JAX's path rules: attention
Q/K/V and the MLP's up-projections shard their OUTPUT features (`_COL`), the
attention output and the MLP's down-projection their INPUT features
(`_ROW`), so each block pair needs one all-reduce over the mesh's `model`
axis. Anything unmatched is replicated; that includes the int8 `kernel_q` /
`scale` leaves, which JAX's rule (it matches `kernel` and `bias` only) also
replicates, so TP over the int8 decoder computes every projection whole on
every rank, as JAX's does.

There is no global array here: `shard_params` cuts THIS rank's slices out of
a full Flax tree (numpy leaves, or torch tensors, which stay on their
device: `models.decoder.decoder_flax_tree` of a loaded model) and tags the
tree with the mesh, and the
decoder built from it (`TextGenerator(cfg, params=shard_params(...))`)
holds only those slices and all-reduces after each `_ROW` product. The
kernels see plain tensors (no DTensor): the int8 and flash wrappers take
raw pointers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch.distributed as dist

from ..parallel.mesh import AXIS_MODEL, AxisGroup

# encoder names + decoder names (q/k/v/gate/up shard output features;
# o_proj/down_proj shard input features → one all-reduce per block pair)
_COL = ("query", "key", "value", "intermediate",
        "q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("output", "mlp_output", "o_proj", "down_proj")


def param_spec(path: tuple) -> tuple:
    """The partition spec of the leaf at `path` (its dict keys): one entry
    per array axis, `"model"` where that axis splits over the mesh's model
    axis; () is replicated (JAX's `P()`)."""
    names = [str(getattr(p, "key", p)) for p in path]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    if parent in _COL:
        if leaf == "kernel":
            return (None, AXIS_MODEL)
        if leaf == "bias":
            return (AXIS_MODEL,)
    if parent in _ROW and leaf == "kernel":
        return (AXIS_MODEL, None)
    return ()


@dataclasses.dataclass(frozen=True)
class TensorParallel(AxisGroup):
    """This rank's place on the model axis: the group the `_ROW` products
    all-reduce over, its size, and this rank's coordinate."""

    @classmethod
    def of(cls, mesh, axis: str = AXIS_MODEL) -> "TensorParallel":
        return super().of(mesh, axis)


class ShardedParams(dict):
    """A Flax tree of this rank's TP slices, with the mesh it was cut for
    (`mesh`) and this rank's place on its model axis (`tp`)."""

    def __init__(self, tree: dict, mesh):
        super().__init__(tree)
        self.mesh = mesh
        self.tp = TensorParallel.of(mesh)


def split_size(n: int, tp, what: str) -> int:
    """This rank's share of `n` features over the model axis (all of them
    without TP); raises where the axis does not divide them."""
    if tp is None:
        return n
    if n % tp.size:
        raise ValueError(f"{what} of {n} does not split over model="
                         f"{tp.size}")
    return n // tp.size


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _slice(x, spec: tuple, tp: TensorParallel):
    """This rank's block of `x` (numpy, or a torch tensor kept on its
    device) along every axis the spec splits."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    for axis, name in enumerate(spec):
        if name != AXIS_MODEL:
            continue
        n = x.shape[axis]
        if n % tp.size:
            raise ValueError(f"axis {axis} of size {n} does not split over "
                             f"model={tp.size}")
        per = n // tp.size
        if isinstance(x, torch.Tensor):
            x = x.narrow(axis, tp.rank * per, per)
        else:
            x = np.take(x, np.arange(tp.rank * per, (tp.rank + 1) * per),
                        axis=axis)
    return x


def shard_params(params, mesh) -> ShardedParams:
    """This rank's slices of a Flax param tree under the TP rules."""
    tp = TensorParallel.of(mesh)
    tree = _map_with_path(lambda path, leaf: _slice(
        leaf, param_spec(path), tp), dict(params))
    return ShardedParams(tree, mesh)


def param_shardings(params, mesh) -> dict:
    """The spec of every leaf (`param_spec`), as JAX's NamedSharding tree
    names one; `mesh` is accepted for JAX's signature."""
    del mesh
    return _map_with_path(lambda path, _: param_spec(path), dict(params))


# torch state dicts (name → tensor) under the same rules: a Linear's
# `weight` is the Flax kernel transposed, so a `_COL` weight [out, in]
# splits axis 0 and a `_ROW` weight axis 1
def split_axis(name: str) -> int | None:
    """The axis of the state-dict entry `name` that the TP rules split
    over the model axis, or None where it is replicated."""
    *scope, leaf = name.split(".")
    flax_leaf = "kernel" if leaf == "weight" else leaf
    spec = param_spec((*scope, flax_leaf))
    if AXIS_MODEL not in spec:
        return None
    axis = spec.index(AXIS_MODEL)
    return len(spec) - 1 - axis if flax_leaf == "kernel" else axis


def slice_entry(name: str, value, tp: TensorParallel):
    """This rank's slice of the state-dict entry `name` (a tensor, or a
    numpy array made one), contiguous; replicated entries as they are."""
    axis = split_axis(name)
    if axis is None or tp is None or tp.size == 1:
        return value
    value = torch.as_tensor(value)
    per = value.shape[axis] // tp.size
    return value.narrow(axis, tp.rank * per, per).contiguous()


def gather_entry(name: str, value, tp: TensorParallel | None):
    """The whole entry `name` from every rank's slice: all-gathered over
    the model axis (every rank of the model group calls this) and
    concatenated along its split axis."""
    axis = split_axis(name)
    if axis is None or tp is None or tp.size == 1:
        return value
    parts = [torch.empty_like(value) for _ in range(tp.size)]
    dist.all_gather(parts, value.contiguous(), group=tp.group)
    return torch.cat(parts, dim=axis)


def slice_state(state: dict, tp: TensorParallel) -> dict:
    """This rank's slices of a whole state dict (e.g. a checkpoint's)."""
    return {n: slice_entry(n, v, tp) for n, v in state.items()}


def gather_state(state: dict, tp: TensorParallel | None) -> dict:
    """The whole state dict from every rank's slices (`gather_entry`)."""
    return {n: gather_entry(n, v, tp) for n, v in state.items()}
