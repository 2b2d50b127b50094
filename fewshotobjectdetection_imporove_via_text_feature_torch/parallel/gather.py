"""Cross-process gather of host Python objects, the counterpart of the JAX
package's ``parallel/gather.py`` (ref detectron2 ``comm.gather``, used by
the evaluators): every rank receives every rank's object, so every rank
can compute the full metrics."""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist

from .mesh import get_world_size, host_group


def allgather_pyobj(obj: Any) -> List[Any]:
    """``obj`` of every rank, in rank order (``[obj]`` with no process
    group). Every rank must call it, in the same order."""
    world = get_world_size()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj, group=host_group())
    return out
