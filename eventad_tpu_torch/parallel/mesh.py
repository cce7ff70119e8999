"""Process groups and the ("data", "model") mesh (counterpart of
``eventad_tpu/parallel/mesh.py``).

The JAX package drives every device from one process; here each device is
a process of its own (``torchrun``, or ``parallel.launch.spawn``), and a
``DeviceMesh`` over ``("data", "model")`` names the groups.  Batches are
split over "data" by item, each rank holding a contiguous block
(``data.batching.rank_items``; the JAX ``_FIELD_SPECS`` is empty, so every
field's item axis leads); parameters are replicated, or sharded over
"model" by ``parallel.sharding``.  Gloo carries CPU tensors and NCCL CUDA
ones; a run that asks for the card and cannot start NCCL raises.
"""
from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist

from ..data.batching import EventBatch, rank_items

AXES = ("data", "model")


def init_distributed(device, *, store_path: str = None, rank: int = None,
                     world_size: int = None):
    """Joins this process to the default process group: NCCL for a CUDA
    ``device`` (the rank's card ``cuda:{LOCAL_RANK}`` becomes the current
    one), gloo for the CPU.  The rendezvous is ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or a
    ``FileStore`` at ``store_path`` with an explicit ``rank`` and
    ``world_size``.  Returns ``(rank, world_size)``."""
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local)
        backend, device_id = "nccl", torch.device("cuda", local)
    else:
        backend, device_id = "gloo", None
    if store_path is not None:
        store = dist.FileStore(str(store_path), world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, device_id=device_id)
    else:
        dist.init_process_group(backend, device_id=device_id)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(spec: str = "1", world: int = None):
    """A ``DeviceMesh`` of shape ``(data, model)`` (spec ``"N"``: ``(N, 1)``,
    ``"NxM"``: ``(N, M)``) over the default process group's ranks
    (row-major: the ranks of one model group are consecutive).  With
    fewer processes than the spec asks for, warn and use a ``(world, 1)``
    data mesh (parameters are replicated, so a smaller mesh is always
    valid, as in the JAX package); a spec that leaves processes out
    raises."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed first")
    world = world or dist.get_world_size()
    d, m = map(int, spec.split("x")) if "x" in spec else (int(spec), 1)
    if d < 1 or m < 1:
        raise ValueError(f"mesh {spec!r}: sizes must be positive")
    if d * m > world:
        warnings.warn(f"mesh {spec} needs {d * m} processes but only "
                      f"{world} available; degrading to {world}x1 "
                      f"data-parallel mesh")
        d, m = world, 1
    if d * m != world:
        raise ValueError(f"mesh {spec} covers {d * m} of {world} processes")
    backend = dist.get_backend()
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", (d, m),
                            mesh_dim_names=AXES)


def data_size(mesh) -> int:
    return mesh["data"].size()


def data_rank(mesh) -> int:
    return mesh.get_local_rank("data")


def mesh_slot(mesh):
    """``(rank, size)`` of this process on the "data" axis; ``(0, 1)``
    without a mesh."""
    return (0, 1) if mesh is None else (data_rank(mesh), data_size(mesh))


def batch_is_empty(batch: EventBatch, mesh=None) -> bool:
    """No current-frame box in the batch: in every rank's block with a
    mesh, so that every rank skips the same batches."""
    if mesh is None:
        return batch.is_empty()
    any_box = batch.bbox_mask.any().to(torch.int32).reshape(1)
    if dist.get_backend() == "nccl":
        any_box = any_box.cuda()
    dist.all_reduce(any_box, op=dist.ReduceOp.MAX)
    return not bool(any_box)


def shard_batch(batch: EventBatch, mesh) -> EventBatch:
    """The rank's contiguous block of ``batch``'s items over the mesh's
    "data" axis (every model rank of one data index holds the same
    block)."""
    return batch.select(rank_items(batch.pos.shape[0], data_rank(mesh),
                                   data_size(mesh)))


def gather_items(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated on the leading axis in rank order
    (the inverse of :func:`shard_batch`)."""
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.dtype)


def replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcasts ``module``'s parameters and buffers from rank 0, so every
    rank starts from the same weights and statistics.  Returns it."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def is_main_process() -> bool:
    """Rank 0 of a process group, or a process outside any: the one that
    writes checkpoints, result files and metrics."""
    return not dist.is_initialized() or dist.get_rank() == 0


def end_distributed() -> None:
    """Leaves the default process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_mesh(spec: str, device, batch_size: int):
    """The mesh an entry module (``train``, ``test``, ``train_detector``)
    runs on for ``--mesh spec``, or None for one process.  ``"1"`` (or
    empty) is one process.  Otherwise the processes come from ``torchrun
    --nproc_per_node N``: a run started as one process says so and runs on
    it; a batch that does not divide over the data axis runs each
    process's whole batch alone (the JAX ``test.py``'s rule), with a
    warning.

    On a card the run computes f32 as f32, with a mesh or without: TF32 is
    turned off for cuDNN and cuBLAS.  Under TF32 the convolutions pick
    their algorithm by the rank's block of the batch, so a mesh's results
    would drift from one card's."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if spec in ("", "1") and int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        print(f"mesh {spec}: this run has one process (start it with "
              f"torchrun --nproc_per_node N for a mesh); running on one "
              f"process", flush=True)
        return None
    init_distributed(device)
    mesh = make_mesh(spec)
    if batch_size % data_size(mesh):
        print(f"warning: batch_size {batch_size} not divisible by "
              f"data-mesh size {data_size(mesh)}; running single-device",
              flush=True)
        return None
    if is_main_process():
        print(f"mesh: data {data_size(mesh)} x model "
              f"{mesh['model'].size()} over {dist.get_world_size()} "
              f"processes ({dist.get_backend()})", flush=True)
    return mesh
