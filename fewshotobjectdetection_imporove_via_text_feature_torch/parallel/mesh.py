"""Process groups, the device mesh and the model wrap of multi-device
training: the counterpart of the JAX package's ``parallel/mesh.py`` (ref
defrcn/engine/defaults.py:252-258, the DDP wrap).

One process drives one device. ``init_distributed`` joins the processes:
NCCL for a CUDA device and gloo for the CPU, unless the caller names the
backend (two gloo ranks may share one card); a backend that does not come
up raises. With no process group every helper answers as a single process
(rank 0 of 1), so single-process paths are unchanged.

``wrap_model`` is the JAX trainer's mesh in PyTorch terms:
``TPU.MODEL_PARALLEL`` 1 is data parallelism (DDP: parameters replicated,
the gradient averaged over ranks); M > 1 is ZeRO-3 on a (data, model) mesh
(FSDP2 ``fully_shard`` on a 2-D ``DeviceMesh``: parameters, gradients and
momentum sharded over ``model``, replicated over ``data``). Either way
every rank takes its own rows of the global batch, and the losses divide
by counts taken over the global batch (``collectives.py``), so the
averaged gradient is that of the JAX package's global-batch loss.
"""

from __future__ import annotations

import socket
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# ZeRO sharding threshold, the JAX package's: a tensor of fewer elements
# saves nothing by its own shard group
ZERO_MIN_SIZE = 1 << 15

# a gloo group beside an NCCL default group, for host-side objects and
# flags: set by init_distributed, cleared by destroy_distributed
_HOST_GROUP = None


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = 1800.0) -> None:
    """Join the process group: NCCL when ``device`` is CUDA, gloo for the
    CPU, or ``backend`` as named. A CUDA ``device`` becomes the current
    device first. Raises when the backend does not come up."""
    global _HOST_GROUP
    device = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s),
        device_id=device if backend == "nccl" else None)
    _HOST_GROUP = (dist.new_group(backend="gloo") if backend != "gloo"
                   else dist.group.WORLD)


def destroy_distributed() -> None:
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def host_group():
    """The gloo group for host objects (the default group under gloo)."""
    return _HOST_GROUP


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier(group=_HOST_GROUP)


def broadcast_seed(seed: int) -> int:
    """Rank 0's ``seed`` on every rank: every rank then draws the same
    weights and the same step generators."""
    if not dist.is_initialized():
        return int(seed)
    t = torch.tensor([int(seed)], dtype=torch.int64)
    dist.broadcast(t, 0, group=_HOST_GROUP)
    return int(t.item())


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on some rank (a host-side
    all-reduce; the flag itself when there is no process group)."""
    if get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def spans_machines() -> bool:
    """Whether the ranks run on more than one host (a host-name
    exchange)."""
    if get_world_size() == 1:
        return False
    names = [None] * get_world_size()
    dist.all_gather_object(names, socket.gethostname(), group=_HOST_GROUP)
    return len(set(names)) > 1


def get_mesh(model: int = 1, device_type: str = "cpu"):
    """The (data, model) ``DeviceMesh`` over every rank: ``model``
    innermost, so a model group is ``model`` consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = get_world_size()
    if world % model:
        raise ValueError(f"TPU.MODEL_PARALLEL {model} must divide the "
                         f"world size {world}")
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))


def param_partition_spec(shape, model: int, min_size: int = ZERO_MIN_SIZE):
    """The JAX package's ZeRO rule for one tensor: the largest dimension
    divisible by ``model`` (ties to the last) is sharded over ``model``;
    a tensor of fewer than ``min_size`` elements, or with no such
    dimension, stays whole. Returns a tuple with "model" at the sharded
    dimension and None elsewhere, () for a whole tensor."""
    if model <= 1 or int(np.prod(shape)) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % model == 0 and d >= model and (
                best is None or d >= shape[best]):
            best = i
    if best is None:
        return ()
    return tuple("model" if i == best else None for i in range(len(shape)))


class _TrainForward(nn.Module):
    """DDP wraps ``forward``: this one is the model's ``forward_train``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args):
        return self.model.forward_train(*args)


def _shard_units(model: nn.Module, model_parallel: int):
    """The modules that get a shard group of their own, innermost first:
    the parents of the modules that directly hold a tensor the ZeRO rule
    shards. The parent, because a module's forward may read a child
    layer's weight without calling it (the RPN head's convolutions), and a
    group is gathered when its module's forward is called."""
    units = set()
    for m in model.modules():
        if any(param_partition_spec(p.shape, model_parallel)
               for c in m.children() for p in c.parameters(recurse=False)):
            units.add(id(m))
    return [m for m in model.modules() if id(m) in units][::-1]


def wrap_model(model: nn.Module, cfg):
    """``model`` (on its device) prepared for the training step of the
    process group; returns the step's forward, ``forward_train``'s
    signature. No process group: the model's own ``forward_train``.
    TPU.MODEL_PARALLEL 1: DDP. M > 1: FSDP2 over a (world / M, M) mesh,
    one shard group for each parent of a layer that holds a tensor the
    ZeRO rule shards (that tensor sharded along the rule's dimension, the
    others along dim 0) and the rest in the root's; the parameters become
    DTensors in place,
    so build the optimizer after this. Frozen parameters stay as they are
    (no gradient, never updated) and GDL's scaled gradients pass through."""
    mp = int(cfg.TPU.MODEL_PARALLEL)
    if not dist.is_initialized():
        if mp > 1:
            raise ValueError(f"TPU.MODEL_PARALLEL {mp} must divide the "
                             "world size 1")
        return model.forward_train
    device = next(model.parameters()).device
    if mp <= 1:
        return nn.parallel.DistributedDataParallel(
            _TrainForward(model),
            device_ids=None,
            # the stages below FREEZE_AT run without autograd, and a
            # painting arch may leave a branch without gradient
            find_unused_parameters=True)
    from torch.distributed.fsdp import (
        fully_shard,
        register_fsdp_forward_method,
    )
    from torch.distributed.tensor import Shard

    mesh = get_mesh(mp, device.type)

    def placement(p):
        spec = param_partition_spec(p.shape, mp)
        return Shard(spec.index("model")) if spec else None

    for unit in _shard_units(model, mp):
        if unit is not model:
            fully_shard(unit, mesh=mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement)
    register_fsdp_forward_method(model, "forward_train")
    return model.forward_train


def is_sharded(model: nn.Module) -> bool:
    """Whether ``model``'s parameters are DTensor shards (FSDP2)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in model.parameters())
