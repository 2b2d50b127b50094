"""Training checkpoints: save, load and resume, with a ``last_checkpoint``
marker, and the JAX package's pickle checkpoints as a source of weights.

Counterpart of the JAX package's ``checkpoint/checkpointer.py``. This
package saves ``{"model", "optimizer", "scheduler", "iteration"}`` with
``torch.save`` as ``<name>.pth``: written to a temporary file, synced and
renamed, then the marker, so a kill mid-save never leaves a truncated file
under a final name. ``save_async`` moves the write to one background
thread after the tensors are copied to the host.

``training_state`` and ``load_training_state`` are the one format of a
training checkpoint, whatever the wrap: whole tensors, and the optimizer's
state keyed by parameter index, as ``optimizer.state_dict()`` gives it in
one process. Under FSDP2 (TPU.MODEL_PARALLEL > 1) the shards are gathered
to save (rank 0 writes), and a whole checkpoint is sharded again to load,
so a checkpoint written at one world size loads at any other.

``load_jax_checkpoint`` reads a JAX package pickle checkpoint (its
``load_checkpoint_file``, copied here) without JAX: objects of jax, flax or
optax classes (the optimizer state's containers) unpickle as inert
stand-ins, numpy arrays as themselves, and any other class is refused; the
flax params go through ``state_dict_from_jax_params``. An orbax directory
checkpoint raises. ``MODEL.WEIGHTS`` files of every format load through
``torch_import.maybe_load_reference_weights``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import torch

from .convert import state_dict_from_jax_params

_FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax")


class _Foreign:
    """Stand-in for an object of a JAX-side class inside a pickle: keeps
    what it was built from and nothing else."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state


class _PortUnpickler(pickle.Unpickler):
    """Numpy arrays and inert stand-ins for JAX-side classes; nothing else
    (unpickling a class can run its code)."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _FOREIGN:
            return type(name, (_Foreign,), {"__module__": module})
        if root == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a JAX package checkpoint holds no {module}.{name}")


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """A JAX package pickle checkpoint (``.ckpt``) as its dict of numpy
    trees; raises for an orbax directory checkpoint."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax directory checkpoints are not read by the "
            "PyTorch package; save with TPU.CHECKPOINT_BACKEND 'pickle'"
        )
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a JAX package pickle checkpoint, as this
    package's ``state_dict``."""
    return state_dict_from_jax_params(load_checkpoint_file(path)["params"])


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(obj):
    """A copy of ``obj`` with every tensor cloned to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class Checkpointer:
    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self._writer = None
        self._pending = None

    def save(self, state: Dict[str, Any], name: str) -> str:
        """Write ``state`` as ``<name>.pth`` and point the marker at it."""
        path = os.path.join(self.save_dir, name + ".pth")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        marker = os.path.join(self.save_dir, "last_checkpoint")
        with open(marker + ".tmp", "w") as f:
            f.write(name + ".pth")
            f.flush()
            os.fsync(f.fileno())
        os.replace(marker + ".tmp", marker)
        _fsync_dir(self.save_dir)
        return path

    def save_async(self, state: Dict[str, Any], name: str) -> None:
        """``save`` on a background thread: the tensors are copied to the
        host here, so the caller may go on updating them. Writes stay in
        order; an error surfaces at the next save or at ``wait``."""
        state = _to_host(state)
        self.wait()
        if self._writer is None:
            from concurrent.futures import ThreadPoolExecutor

            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = self._writer.submit(self.save, state, name)

    def wait(self) -> None:
        """Drain an in-flight ``save_async``; re-raise its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def load(self, path: str, map_location="cpu") -> Dict[str, Any]:
        """A checkpoint of this package (``.pth``)."""
        return torch.load(path, map_location=map_location,
                          weights_only=True)

    def load_latest(self, map_location="cpu") -> Optional[Dict[str, Any]]:
        self.wait()
        marker = os.path.join(self.save_dir, "last_checkpoint")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            name = f.read().strip()
        return self.load(os.path.join(self.save_dir, name), map_location)


def _params_in_order(optimizer):
    """The parameters in the optimizer's order (its state indices)."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def _whole(obj, cpu: bool):
    """``obj`` with every DTensor gathered whole (on the CPU with
    ``cpu``)."""
    from ..parallel.collectives import full_tensor

    if isinstance(obj, torch.Tensor):
        t = full_tensor(obj).detach()
        return t.to("cpu", copy=True) if cpu else t
    if isinstance(obj, dict):
        return {k: _whole(v, cpu) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_whole(v, cpu) for v in obj)
    return obj


def training_state(model, optimizer, scheduler, iteration: int):
    """The checkpoint of a training run: ``{"model", "optimizer",
    "scheduler", "iteration"}``, in a single process's format (the
    optimizer's state keyed by parameter index). Under FSDP2 every rank
    must call it: the shards are gathered, to the CPU."""
    from ..parallel.mesh import is_sharded

    state = {"scheduler": scheduler.state_dict(), "iteration": iteration}
    if not is_sharded(model):
        return {"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), **state}
    return {"model": _whole(model.state_dict(), cpu=True),
            "optimizer": _whole(optimizer.state_dict(), cpu=True), **state}


def load_training_state(model, optimizer, state) -> None:
    """Load a checkpoint of ``training_state`` (written at any world size)
    into ``model`` and, when it has one, ``optimizer``; under FSDP2 each
    rank keeps its shards of the whole tensors."""
    from ..parallel.collectives import shard_like
    from ..parallel.mesh import is_sharded

    if not is_sharded(model):
        model.load_state_dict(state["model"])
        if "optimizer" in state:
            optimizer.load_state_dict(state["optimizer"])
        return
    from torch.distributed.tensor import DTensor

    live = model.state_dict()
    if set(live) != set(state["model"]):
        raise KeyError(
            f"checkpoint keys differ: missing "
            f"{sorted(set(live) - set(state['model']))[:5]}, unexpected "
            f"{sorted(set(state['model']) - set(live))[:5]}")
    with torch.no_grad():
        for k, t in live.items():
            full = state["model"][k]
            if isinstance(t, DTensor):
                t.to_local().copy_(shard_like(full, t).to_local())
            else:
                t.copy_(full)
    if "optimizer" in state:
        params = _params_in_order(optimizer)
        osd = state["optimizer"]
        optimizer.load_state_dict({**osd, "state": {
            i: {k: shard_like(v, params[i]) if torch.is_tensor(v)
                and v.dim() else v for k, v in st.items()}
            for i, st in osd["state"].items()}})


def full_model_state(model):
    """``model``'s state dict with whole tensors (under FSDP2 a gather
    every rank must join; the model's own otherwise)."""
    from ..parallel.mesh import is_sharded

    if not is_sharded(model):
        return model.state_dict()
    return _whole(model.state_dict(), cpu=False)
