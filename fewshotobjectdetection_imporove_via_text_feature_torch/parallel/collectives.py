"""What makes an N-rank training step compute the JAX package's
global-batch step (under pjit the JAX package gets these for free):

  * ``global_normalizer``: a loss that divides a sum by a count over the
    batch (valid ROIs, foreground ROIs) divides its local sum by the global
    count over N, so that the mean over ranks of the local losses, which is
    what DDP's averaged gradient differentiates, is the global loss;
  * ``mean_over_ranks``: the logged losses, the same on every rank;
  * ``all_gather_with_grad``: the teacher's cross-ROI attention attends
    over every rank's ROIs, and the gradient flows back to their owners;
  * ``local_rand``: a draw over the batch (anchor and ROI sampling, cls
    dropout) is made at the global batch's shape from the step's
    generator, and each rank keeps its own rows;
  * ``local_rows``: a rank's rows of a global batch;
  * ``full_tensor`` and ``shard_like``: an FSDP2 shard (a DTensor) as its
    whole tensor and back, over plain all-gathers (DTensor's own
    redistribution runs functional collectives, which gloo does not carry
    on CUDA tensors).

Each is the identity of a single process when there is no process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import get_rank, get_world_size


def global_count(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of the detached count ``x``."""
    if get_world_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def global_normalizer(count: torch.Tensor) -> torch.Tensor:
    """max(global count, 1) / world: a local sum divided by it is a loss
    whose mean over ranks is sum / max(global count, 1), the global-batch
    loss, and DDP's mean of the gradients is that loss's gradient. With no
    process group, max(count, 1)."""
    world = get_world_size()
    if world == 1:
        return torch.clamp(count, min=1)
    return torch.clamp(global_count(count), min=1) / world


def mean_over_ranks(values: dict) -> dict:
    """{name: scalar tensor} averaged over ranks (one all-reduce)."""
    world = get_world_size()
    if world == 1 or not values:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked = stacked / world
    return {k: stacked[i] for i, k in enumerate(keys)}


class _AllGatherWithGrad(torch.autograd.Function):
    """Every rank's rows, concatenated in rank order; the gradient of a
    rank's rows is the sum over ranks of the gradients their copies got
    (an all-reduce, which every backend has on every device)."""

    @staticmethod
    def forward(ctx, x):
        world, rank = get_world_size(), get_rank()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        lo, hi = ctx.rows
        return grad[lo:hi]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """(N, ...) on each rank -> (world * N, ...), rank r's rows at [r * N,
    (r + 1) * N), with the gradient sent back to each rank's rows. Every
    rank's N must be equal. ``x`` itself with no process group."""
    if get_world_size() == 1:
        return x
    if not x.requires_grad:
        parts = [torch.empty_like(x) for _ in range(get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=0)
    return _AllGatherWithGrad.apply(x)


def local_rand(shape, generator=None, device=None) -> torch.Tensor:
    """Uniform [0, 1) of ``shape`` whose leading axis is this rank's rows of
    the global batch: drawn at (world * shape[0], ...) from ``generator``
    and sliced, so N ranks draw what one process draws for the whole
    batch, and the generator advances alike on every rank. A generator on
    another device than ``device`` (a host generator for a CUDA draw) draws
    on its own device and the draw is copied to ``device``."""
    world = get_world_size()
    at = device if generator is None else generator.device
    if world == 1:
        return torch.rand(shape, generator=generator, device=at).to(device)
    n = shape[0]
    full = torch.rand((world * n, *shape[1:]), generator=generator,
                      device=at)
    r = get_rank()
    return full[r * n:(r + 1) * n].to(device)


def local_rows(batch):
    """This rank's rows of a global ``(ImageBatch, GTInstances[, meta])``
    batch: the contiguous ``batch / world`` slice of each tensor (and of
    ``meta``'s per-image lists), as the train loader slices each global
    batch. The batch itself with no process group."""
    world = get_world_size()
    if world == 1:
        return batch
    images, gt = batch[0], batch[1]
    b = images.image.shape[0]
    if b % world:
        raise ValueError(f"batch {b} is not divisible by the world size "
                         f"{world}")
    n = b // world
    lo, hi = get_rank() * n, (get_rank() + 1) * n

    def rows(obj):
        return type(obj)(**{k: v[lo:hi] for k, v in vars(obj).items()})

    out = (rows(images), rows(gt))
    if len(batch) > 2:
        meta = dict(batch[2])
        for k in ("image_ids", "file_names", "short", "flip"):
            if k in meta:
                meta[k] = meta[k][lo:hi]
        if "valid_count" in meta:
            meta["valid_count"] = min(max(meta["valid_count"] - lo, 0), n)
        out += (meta,)
    return out


def _sharding(t):
    """(mesh dimension, tensor dimension) of a DTensor's Shard placement,
    or None when every placement is Replicate (FSDP2 has at most one)."""
    from torch.distributed.tensor import Shard

    shards = [(m, p.dim) for m, p in enumerate(t.placements)
              if isinstance(p, Shard)]
    if len(shards) > 1:
        raise NotImplementedError(f"placements {t.placements}")
    return shards[0] if shards else None


def _chunk(size: int, n: int, c: int):
    """[lo, hi) of chunk ``c`` of ``n`` over ``size`` (torch.chunk's, as
    DTensor's Shard splits)."""
    step = -(-size // n)
    lo = min(c * step, size)
    return lo, min(lo + step, size)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor as its whole tensor on its device (every rank of its
    shard's mesh dimension calls it); any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    sharding = _sharding(t)
    if sharding is None:
        return local
    m, d = sharding
    n, size = t.device_mesh.size(m), t.shape[d]
    step = -(-size // n)
    padded = list(local.shape)
    padded[d] = step
    buf = local.new_zeros(padded)
    buf.narrow(d, 0, local.shape[d]).copy_(local)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=t.device_mesh.get_group(m))
    return torch.cat(parts, dim=d).narrow(d, 0, size)


def shard_like(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's part of the whole tensor ``full``, placed as the DTensor
    ``like`` (no communication)."""
    from torch.distributed.tensor import DTensor

    local = full
    sharding = _sharding(like)
    if sharding is not None:
        m, d = sharding
        lo, hi = _chunk(full.shape[d], like.device_mesh.size(m),
                        like.device_mesh.get_local_rank(m))
        local = full.narrow(d, lo, hi - lo)
    return DTensor.from_local(
        local.to(device=like.device, dtype=like.dtype).contiguous(),
        like.device_mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride())
