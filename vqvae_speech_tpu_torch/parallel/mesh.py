"""The (data, model) device mesh over ``torch.distributed``.

Counterpart of ``vqvae_speech_tpu/parallel/mesh.py``. The JAX package runs
ONE program over a ``jax.sharding.Mesh`` of every device it sees; PyTorch's
idiom is one process a device, joined by a process group, with a
``DeviceMesh`` naming the axes:

  data  - batch sharding (data parallelism); the state is replicated.
  model - codebook or channel sharding (``parallel.sharded_vq``,
          ``parallel.tp_decode``); size 1 by default.

Rank ``d * num_model + m`` holds mesh coordinate (d, m), as
``init_device_mesh`` lays a row-major mesh out. A batch is sharded as
``P("data")`` shards it: data rank d holds the d-th contiguous block of the
leading axis (``shard_batch``).

What the JAX compiler inserts for a data-parallel step, the port writes out:
``all_gather_rows`` (a differentiable gather of the rows of a batch),
``all_reduce_mean`` (one coalesced all-reduce of a gradient list) and
``global_mean`` (a metric's mean over the data axis). The backend follows
the device the caller names: NCCL for CUDA, gloo for the CPU. Every process
group this module opens has a finite timeout, so that a rank that never
arrives ends the run instead of hanging it.
"""
import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")
# a collective that waits longer than this raises on every rank
DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *, device,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Join this process to a world of ``num_processes`` ranks as rank
    ``process_id``, through the TCP store at ``coordinator_address``
    (``host:port``; rank 0 listens there). A no-op without a coordinator
    (one process) and when the default group exists already. The backend
    follows ``device``: NCCL for CUDA (bound to that device, which becomes
    the process's current one), gloo for the CPU; there is no fallback from
    one to the other."""
    if coordinator_address is None or dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout,
                            device_id=device if cuda else None)


def initialize_from_environment(*, device,
                                timeout: datetime.timedelta = DEFAULT_TIMEOUT
                                ) -> torch.device:
    """Under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment): join the world
    and return this rank's device, ``cuda:LOCAL_RANK`` when ``device`` is
    CUDA. Without ``WORLD_SIZE`` it returns ``device`` and opens nothing."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    initialize_multihost(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
        device=device, timeout=timeout)
    return device


def shutdown() -> None:
    """Close the default process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(num_data: Optional[int] = None, num_model: int = 1, *, device):
    """A (data, model) ``DeviceMesh`` over the whole world; ``num_data``
    defaults to world_size // num_model. Needs an initialized process group
    (callers on one device pass ``mesh=None``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(initialize_multihost); on one device pass "
                           "mesh=None")
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"a ({num_data}, {num_model}) mesh does not cover "
                         f"the world of {world} ranks")
    return init_device_mesh(torch.device(device).type, (num_data, num_model),
                            mesh_dim_names=AXES)


def check_mesh(mesh) -> None:
    """Raises TypeError unless ``mesh`` is None or a DeviceMesh with the
    (data, model) axes."""
    if mesh is None:
        return
    from torch.distributed.device_mesh import DeviceMesh

    if (not isinstance(mesh, DeviceMesh)
            or tuple(mesh.mesh_dim_names or ()) != AXES):
        raise TypeError(f"mesh={mesh!r}: expected None or a DeviceMesh with "
                        f"axes {AXES} (parallel.make_mesh)")


def mesh_shape(mesh) -> dict:
    """{"data": n, "model": m}, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_writer() -> bool:
    """Whether this rank writes checkpoints and logs: the whole world's rank
    0 (every rank without a process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh) -> None:
    """Wait for every rank of the world (nothing without a mesh)."""
    if mesh is not None:
        dist.barrier()


@dataclass
class MeshConfiguration:
    """A run's resolved mesh (the reference's DeviceConfiguration,
    device_configuration.py:32-76, as mesh axes). The data axis spans
    world_size // num_model_shards ranks when ``use_data_parallel`` is set,
    else 1; ``mesh`` is None in a world of one rank (no process group) and
    when the axes do not cover the world."""

    mesh: Optional[object]
    backend: Optional[str]
    data_axis_size: int

    @classmethod
    def load_from_configuration(cls, configuration: dict, *,
                                device) -> "MeshConfiguration":
        num_model = int(configuration.get("num_model_shards", 1) or 1)
        want_dp = bool(configuration.get("use_data_parallel", False))
        if not dist.is_initialized():
            return cls(None, None, 1)
        world = dist.get_world_size()
        num_data = max(world // num_model if want_dp else 1, 1)
        mesh = (make_mesh(num_data, num_model, device=device)
                if num_data * num_model == world and world > 1 else None)
        return cls(mesh, dist.get_backend(), num_data)

    @property
    def use_data_parallel(self) -> bool:
        return self.data_axis_size > 1


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_rows(x, mesh):
    """This data rank's contiguous block of the leading axis of ``x`` (a
    tensor or a numpy array); the axis must divide by the data axis."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not divide over "
                         f"the data axis of {n} ranks")
    per = x.shape[0] // n
    return x[r * per:(r + 1) * per]


def shard_batch(batch, mesh):
    """A host or device batch (a tree of arrays or tensors, batch-leading)
    as this rank's block of every leaf, the layout of ``P("data")``;
    ``mesh=None`` returns it unchanged."""
    if mesh is None:
        return batch
    return _map(lambda x: shard_rows(x, mesh), batch)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def replicate(tree, mesh):
    """Broadcast every tensor of ``tree`` (a module's parameters and
    buffers, or a tree of tensors) from data rank 0 over the data axis, in
    place; returns ``tree``."""
    if mesh is None or axis_size(mesh, "data") == 1:
        return tree
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.data, src=src, group=group)
    return tree


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 in rank order; the backward sums every rank's
    gradient of the whole gathered tensor and keeps this rank's block (a
    reduce-scatter written as an all-reduce, which gloo and NCCL both
    take: PyTorch's own differentiable all_gather fails in its backward on
    a gloo subgroup)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        at = ctx.rank * ctx.rows
        return grad[at:at + ctx.rows], None


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global tensor whose data-rank-ordered blocks are every rank's
    ``x`` (the inverse of ``shard_rows``); differentiable."""
    if mesh is None or axis_size(mesh, "data") == 1:
        return x
    return _GatherRows.apply(x, mesh.get_group("data"))


def all_reduce_mean(tensors, mesh) -> list:
    """The mean over the data axis of each of a list of same-dtype tensors,
    from ONE all-reduce of their concatenation (a sum, then a division by
    the axis size: gloo has no average); views of that one buffer, in the
    list's order. Without a mesh, the list."""
    tensors = list(tensors)
    if mesh is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    flat /= axis_size(mesh, "data")
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def global_mean(value: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the data axis of a per-rank value (a local batch mean
    of equal shards is then the global batch's mean); detached."""
    if mesh is None:
        return value
    out = value.detach().clone()
    dist.all_reduce(out, group=mesh.get_group("data"))
    return out / axis_size(mesh, "data")


def global_rows(local_rows: int, mesh) -> int:
    """The global batch size of a local batch of ``local_rows``."""
    return local_rows * axis_size(mesh, "data")

