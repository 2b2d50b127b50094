"""Start one process a device and join them: the reference's ``launch``
(detectron2 engine/launch.py; the JAX package's counterpart is
``jax.distributed.initialize`` in its ``cli.py``).

    launch(main_fn, num_gpus=2, args=(argv,))                 # 2 cards
    launch(main_fn, 2, backend="gloo",
           devices=["cuda:0", "cuda:0"], args=...)             # 2 ranks, 1 card
    launch(main_fn, 8, num_machines=2, machine_rank=r,
           dist_url="tcp://host0:port", args=...)              # 2 machines

Each local rank runs ``main_fn(*args)`` in a spawned process after
``parallel.init_distributed``; ``launch`` returns their return values in
local-rank order. A rank that fails ends the launch: the others are
stopped and ``launch`` raises. A SIGTERM to this process is passed on to
every rank (the trainer then saves and stops them together).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import signal
import socket
import time
from typing import Callable, Optional, Sequence


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(local_rank: int, main_fn: Callable, args: tuple, world: int,
              rank0: int, dist_url: str, backend: Optional[str], device,
              results) -> None:
    from ..parallel import destroy_distributed, init_distributed

    init_distributed(rank0 + local_rank, world, dist_url, backend, device)
    try:
        # plain pickle: the queue's own would hand tensors over by file
        # descriptor, which dies with this process
        results.put((local_rank, pickle.dumps(main_fn(*args))))
    finally:
        destroy_distributed()


def launch(main_fn: Callable, num_gpus: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: str = "auto", args=(),
           backend: Optional[str] = None,
           devices: Optional[Sequence[str]] = None,
           timeout: Optional[float] = None) -> list:
    """Run ``main_fn(*args)`` on ``num_gpus`` local ranks of a world of
    ``num_gpus * num_machines``; returns the local ranks' results. One rank
    in all runs in this process with no process group. ``dist_url``
    "auto" is a free localhost port, for one machine only; ``devices``
    maps local ranks to devices (``cuda:{local_rank}`` by default);
    ``backend`` overrides NCCL on CUDA and gloo on the CPU. ``timeout``
    (seconds) stops every rank and raises ``TimeoutError`` when exceeded.
    ``main_fn`` must be importable by name (the ranks are spawned)."""
    world = num_gpus * num_machines
    if world == 1:
        return [main_fn(*args)]
    if dist_url == "auto":
        if num_machines > 1:
            raise ValueError(
                "--num-machines > 1 needs an explicit --dist-url "
                "tcp://host:port (machine 0's address)")
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    devices = list(devices or [f"cuda:{i}" for i in range(num_gpus)])
    if len(devices) != num_gpus:
        raise ValueError(f"{len(devices)} devices for {num_gpus} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_run_rank, daemon=False,
        args=(i, main_fn, tuple(args), world, machine_rank * num_gpus,
              dist_url, backend, devices[i], results))
        for i in range(num_gpus)]
    for p in procs:
        p.start()

    def forward_term(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, forward_term)
    except ValueError:  # not the main thread
        prev = None
    got = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            # drain before joining: a rank blocks on a full queue
            try:
                i, out = results.get(timeout=0.2)
                got[i] = pickle.loads(out)  # written by this launch's ranks
            except queue.Empty:
                pass
            failed = [(i, p.exitcode) for i, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"launch: local rank {failed[0][0]} exited with code "
                    f"{failed[0][1]}; the other ranks were stopped")
            if len(got) == num_gpus and all(
                    p.exitcode == 0 for p in procs):
                break
            if all(p.exitcode == 0 for p in procs) and results.empty():
                missing = sorted(set(range(num_gpus)) - set(got))
                raise RuntimeError(f"launch: local ranks {missing} exited "
                                   "without a result")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"launch: the ranks ran past {timeout} s and were "
                    "stopped")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(30)
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
    return [got[i] for i in range(num_gpus)]
