"""Device mesh and sharding helpers: the port's topology layer.

Port of `rag_dpo_tpu/parallel/mesh.py`. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the axes ("data", "model",
"shard"), one process ("rank") per device: rank r drives `cuda:<local
rank>` over NCCL, or the CPU over gloo when the caller asks for
`device_type="cpu"`. The axis vocabulary is the JAX package's:

* ``data``  — batch parallelism (the data-parallel corpus encode);
* ``model`` — tensor parallelism (`models/sharding.py`);
* ``shard`` — index sharding: each rank holds a contiguous block of the
  corpus rows, scores it, and the top-k lists merge through one all-gather
  (`parallel.collectives`); the ring of `ops.ring_attention` runs on it.

JAX's global arrays have no torch counterpart: a rank holds its own rows as
a plain tensor. `shard_leading_axis` cuts them from a full array,
`host_local_rows` takes them as each rank loaded them, `replicated` puts a
whole array on the rank's device.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SHARD = "shard"
AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SHARD)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Any axis may be 1 (strategy disabled)."""

    data: int = 1
    model: int = 1
    shard: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.shard

    @classmethod
    def for_devices(cls, n: int, *, model: int = 1) -> "MeshSpec":
        """Default layout: give everything not used by TP to index sharding."""
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        return cls(data=1, model=model, shard=n // model)


def local_device_count() -> int:
    """The cards this host has (0 without one)."""
    return torch.cuda.device_count()


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(device_type: str | None,
             backend: str | None = None) -> tuple[str, str]:
    """(device type, backend): "cpu" is gloo; anything else is the card
    over NCCL (or gloo on CUDA tensors when `backend="gloo"` is asked:
    several ranks on one card, which NCCL refuses), and without a card it
    raises, as `ops.default_device` does: nothing falls back to the
    CPU."""
    if device_type == "cpu":
        return "cpu", "gloo"
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend is 'nccl' or 'gloo', got {backend!r}")
    if device_type not in (None, "cuda"):
        raise ValueError(f"device_type is 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            'device_type="cpu" for a gloo mesh on the CPU')
    return "cuda", backend or "nccl"


# --------------------------------------------------------- process group
def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         device_type: str | None = None,
                         backend: str | None = None) -> None:
    """Join this process to a multi-process deployment: one rank per
    device, `init_process_group` over `tcp://<coordinator_address>`
    (host:port) with `num_processes` ranks, this one `process_id`. With
    no address, the launcher's environment (`WORLD_SIZE`, `RANK`,
    `MASTER_ADDR`, `MASTER_PORT`, as torchrun sets them) is used, and
    without it there is nothing to join: a no-op, as JAX's auto mode in a
    single process is. Idempotent: a second call in an initialized
    process does nothing. On the card the rank drives `cuda:<local rank>`
    (`LOCAL_RANK`, else the rank modulo the host's cards); `backend="gloo"`
    joins card ranks over gloo instead of NCCL."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "WORLD_SIZE" not in os.environ:
        return
    dev_type, backend = _backend(device_type, backend)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        init, world, rank = (f"tcp://{coordinator_address}",
                             int(num_processes), int(process_id))
    else:
        init, world, rank = ("env://", int(os.environ["WORLD_SIZE"]),
                             int(os.environ.get("RANK", 0)))
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _ensure_group(device_type: str | None) -> None:
    """A world of one on a free loopback port when no group exists, so a
    single process builds a mesh as JAX's does without any init."""
    if not dist.is_initialized():
        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                             device_type=device_type)


def create_mesh(spec: MeshSpec | None = None, devices=None,
                device_type: str | None = None):
    """The (data, model, shard) mesh over the ranks of the process group
    (`devices`: their global ranks, default all of them; a world of one is
    made when no group exists). `shard` is innermost, as in JAX, so the
    top-k merges run between neighbouring ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    dev_type, backend = _backend(device_type)
    _ensure_group(dev_type)
    if dev_type == "cuda" and dist.get_backend() == "gloo":
        backend = "gloo"                 # card ranks joined over gloo
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, a "
                         f"{dev_type} mesh needs {backend}")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if spec is None:
        spec = MeshSpec.for_devices(len(ranks))
    if spec.n_devices != len(ranks):
        raise ValueError(
            f"mesh {spec} needs {spec.n_devices} devices, have {len(ranks)}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        spec.data, spec.model, spec.shard)
    return DeviceMesh(dev_type, grid, mesh_dim_names=AXES)


def create_multihost_mesh(spec: MeshSpec | None = None, *,
                          allow_split_collectives: bool = False,
                          device_type: str | None = None):
    """The mesh over every rank of every host, host-major (global ranks in
    order), so with spec.data a multiple of the host count only the data
    axis crosses hosts. Hosts are the groups of `LOCAL_WORLD_SIZE` ranks
    (one rank a host when the launcher does not say). Raises where the
    spec does not cover the world, and where model × shard does not
    divide a host's ranks unless `allow_split_collectives`."""
    _ensure_group(_backend(device_type)[0])
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    n_hosts = max(world // per_host, 1)
    if spec is None:
        spec = MeshSpec(data=n_hosts, model=1, shard=world // n_hosts)
    if spec.n_devices != world:
        raise ValueError(f"mesh {spec} covers {spec.n_devices} devices but "
                         f"the deployment has {world}")
    inner = spec.model * spec.shard
    if n_hosts > 1 and per_host % inner and not allow_split_collectives:
        raise ValueError(
            f"model×shard={inner} does not divide the {per_host} devices "
            f"per host: shard/model collectives would cross hosts. Use a "
            f"data axis that is a multiple of the host count, or pass "
            f"allow_split_collectives=True")
    return create_mesh(spec, device_type=device_type)


# ------------------------------------------------------------ mesh reads
def axis_size(mesh, axis: str | tuple = AXIS_SHARD) -> int:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return int(np.prod([mesh.size(AXES.index(a)) for a in names]))


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's place on one axis of a mesh: the axis's process group,
    its size, and this rank's coordinate (its rank in the group)."""
    group: object
    size: int
    rank: int

    @classmethod
    def of(cls, mesh, axis: str):
        return cls(mesh.get_group(axis), axis_size(mesh, axis),
                   axis_index(mesh, axis))


def axis_index(mesh, axis: str | tuple = AXIS_SHARD) -> int:
    """This rank's coordinate along `axis` (several axes: major first)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    idx = 0
    for a in names:
        idx = idx * mesh.size(AXES.index(a)) + mesh.get_local_rank(a)
    return idx


def mesh_device(mesh) -> torch.device:
    """The device this rank drives."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_row_range(n: int, mesh, axis: str | tuple = AXIS_SHARD
                    ) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous block of `n` leading rows split
    over `axis` (n a multiple of the axis size)."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} shards")
    per = n // size
    lo = axis_index(mesh, axis) * per
    return lo, lo + per


def shard_leading_axis(mesh, x, axis: str | tuple = AXIS_SHARD):
    """This rank's rows of `x` (numpy or tensor, [N, ...]) on its device."""
    lo, hi = local_row_range(x.shape[0], mesh, axis)
    return torch.as_tensor(x[lo:hi]).to(mesh_device(mesh))


def replicated(mesh, x):
    """All of `x` on this rank's device."""
    return torch.as_tensor(x).to(mesh_device(mesh))


def host_local_rows(global_shape, mesh, local_data,
                    axis: str | tuple = AXIS_SHARD):
    """This rank's rows of a [global_shape[0], ...] array split along
    `axis`, as this process loaded them (no process holds another's rows):
    checked against the global shape and put on the rank's device."""
    lo, hi = local_row_range(int(global_shape[0]), mesh, axis)
    want = (hi - lo, *tuple(global_shape[1:]))
    if tuple(local_data.shape) != want:
        raise ValueError(f"this rank holds rows [{lo}, {hi}) of "
                         f"{tuple(global_shape)}: expected {want}, got "
                         f"{tuple(local_data.shape)}")
    return torch.as_tensor(np.asarray(local_data)).to(mesh_device(mesh))


# ------------------------------------------------- context-parallel scope
class context_parallel:
    """`with context_parallel(mesh): model(...)` — encoder layers with
    `attention_impl='ring'` split the sequence over the mesh's `shard`
    axis and pass K/V blocks around the ring. The scope is a stack of the
    process, as JAX's scoped global is."""

    _stack: list = []

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        context_parallel._stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        context_parallel._stack.pop()
        return False


def active_cp_mesh():
    return context_parallel._stack[-1] if context_parallel._stack else None
