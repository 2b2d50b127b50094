"""The training step and the training loop.

Counterpart of the JAX package's ``engine/trainer.py``. ``make_train_step``
is one step: forward (``GeneralizedRCNN.forward_train``), the total of the
non-``metric/`` losses, backward, gradient clipping, SGD and the LR
schedule. ``COMPUTE_DTYPE`` bfloat16 runs through the modules' own casts
over float32 master weights, as the serving path does; there is no
autocast. Each step's anchor/ROI sampling and cls dropout draw from two
generators seeded from the run's seed and the iteration. float32 training
on CUDA runs each step under ``exact_float32()`` (TF32 off, deterministic
algorithms), so a seed gives one result on the card.

``Trainer`` runs the loop on ``cfg.MODEL.DEVICE`` ("cuda" by default, and
it raises when CUDA is absent). Its batches come from
``build_detection_train_loader(cfg, seed=...)`` (page-locked on CUDA), or
from an iterable of ``(ImageBatch, GTInstances[, meta])`` that the caller
passes; ``device_batches`` copies each to the device as the loop takes
it, on a stream of its own on CUDA. It logs every 20 iterations ("iter N" lines, metrics.json), saves
every ``SOLVER.CHECKPOINT_PERIOD`` steps and ``model_final`` at the end,
resumes the iteration, optimizer and scheduler from the newest checkpoint,
and on SIGTERM saves and stops. A batch of the device-preprocessing loader
(TPU.DEVICE_PREPROCESS: raw pixels and the resize's draws in its meta) is
resized on the device first. TPU.DEBUG_NANS checks each step's losses and
gradients and raises ``FloatingPointError`` on the first non-finite one;
TPU.PROFILE_START_STEP / PROFILE_NUM_STEPS trace a window of steps with
``torch.profiler`` into OUTPUT_DIR/profile; under a profiler each step's
stages are spans (``utils/tracing.py``): ``train.fetch``,
``train.forward``, ``train.backward``, ``train.optimizer``, ``train.log``
and ``train.checkpoint``.

Under a process group (``parallel.init_distributed``, one process a
device, as ``engine/launch.py`` starts them) each rank takes its
``IMS_PER_BATCH / world`` rows of every global batch and the model is
wrapped by ``parallel.wrap_model``: DDP, or FSDP2 when
TPU.MODEL_PARALLEL > 1 (one machine only, as in the JAX package). The
step's losses and gradient are those of the global batch, and the logged
losses are the same on every rank. Rank 0 writes metrics.json, the log
and the checkpoints in OUTPUT_DIR, the others their metrics under
OUTPUT_DIR/rank{r}; a SIGTERM on any rank stops every rank after the same
step, with one checkpoint.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..checkpoint import (
    Checkpointer,
    full_model_state,
    init_weights,
    load_training_state,
    maybe_load_reference_weights,
    training_state,
)
from ..data.device_preprocess import preprocess_batch
from ..data.loader import build_detection_train_loader, device_batches
from ..models import build_model
from ..parallel import (
    any_rank,
    broadcast_seed,
    get_rank,
    get_world_size,
    is_main_process,
    is_sharded,
    local_rows,
    mean_over_ranks,
    spans_machines,
    wrap_model,
)
from ..solver import build_gradient_clipper, build_optimizer, build_scheduler
from ..utils.events import MetricsLogger
from ..utils.tracing import span
from .predictor import resolve_device

# options of the JAX trainer that this package does not have:
# (key, the value that is honoured, where ROADMAP.md puts the rest)
_NOT_PORTED = (
    ("TPU.CHECKPOINT_BACKEND", "pickle",
     "Queue 1 item 8 (orbax is a JAX library: orbax checkpoints stay "
     "refused)"),
)


def check_training_config(cfg) -> None:
    """Raise for a training option this package does not honour."""
    if cfg.TPU.SPATIAL_PARTITION > 1:
        # as the JAX trainer: accepting it would train plain data
        # parallelism without saying so
        raise ValueError(
            "TPU.SPATIAL_PARTITION applies to DefaultPredictor serving "
            "only; training parallelism is TPU.MODEL_PARALLEL + the data "
            "ranks")
    for dotted, ok, where in _NOT_PORTED:
        node = cfg
        for part in dotted.split("."):
            node = node[part]
        if node != ok:
            raise NotImplementedError(
                f"{dotted} = {node!r} is not ported to the PyTorch package "
                f"yet: ROADMAP.md {where}"
            )


def rank_output_dir(cfg) -> str:
    """OUTPUT_DIR on rank 0, OUTPUT_DIR/rank{r} on the others."""
    if is_main_process():
        return cfg.OUTPUT_DIR
    return os.path.join(cfg.OUTPUT_DIR, f"rank{get_rank()}")


def default_setup(cfg) -> int:
    """Create this rank's output directory (``rank_output_dir``), write
    the config there, and return the seed: SEED when it is >= 0, else a
    random one (rank 0's on every rank)."""
    out = rank_output_dir(cfg)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    if cfg.SEED >= 0:
        return int(cfg.SEED)
    return broadcast_seed(int.from_bytes(os.urandom(3), "little"))


def step_generators(seed: int, step: int, device):
    """(sampling, dropout) ``torch.Generator``s on ``device`` for one step,
    seeded from (seed, step): a step draws the same numbers again on resume."""
    a, b = np.random.SeedSequence([seed, step]).generate_state(2)
    return (torch.Generator(device=device).manual_seed(int(a)),
            torch.Generator(device=device).manual_seed(int(b)))


def check_finite(step: int, losses, named_params) -> None:
    """Raise ``FloatingPointError`` naming ``step`` and the losses and
    gradients that hold a NaN or an infinity (one host sync when all are
    finite). Under a process group every rank raises when one finds a
    non-finite value in its losses or its shards of the gradients."""
    from torch.distributed.tensor import DTensor

    tensors = list(losses.items()) + [
        (f"grad of {n}",
         p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad)
        for n, p in named_params if p.grad is not None]
    finite = bool(torch.stack([torch.isfinite(t).all()
                               for _, t in tensors]).all())
    if not any_rank(not finite):
        return
    bad = [name for name, t in tensors if not bool(torch.isfinite(t).all())]
    raise FloatingPointError(
        f"step {step}: non-finite {', '.join(bad[:8])}"
        + (f" and {len(bad) - 8} more" if len(bad) > 8 else ""))


@contextlib.contextmanager
def exact_float32():
    """float32 on CUDA as on the CPU: TF32 off in cuBLAS and cuDNN, cuDNN's
    deterministic algorithms and PyTorch's deterministic mode (a warning,
    not an error, for an op with no deterministic version), each restored
    on exit. Under it a step gives the same result every time on one
    card. cuBLAS keeps its workspace: on the step's one stream its GEMMs
    repeat, and a workspace set for some processes only (spawned ranks
    inherit the environment) would change their rounding against the
    others'."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
             cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved[:4]
        torch.use_deterministic_algorithms(saved[4], warn_only=saved[5])


def make_train_step(model, optimizer, scheduler=None, clip=None,
                    seed: int = 0, debug_nans: bool = False, forward=None,
                    draw_device=None):
    """Returns ``train_step(images, gt, step, meta=None) -> losses``: one
    SGD step of ``model`` on a batch already on the model's device; the
    losses come back detached, with ``total_loss``, averaged over the
    ranks (the global batch's). ``forward``: the step's forward
    (``parallel.wrap_model``'s), ``model.forward_train`` by default. A raw
    batch of the device-preprocessing loader (``meta`` with its
    ``target_hw``) is resized on the device first. ``debug_nans`` checks
    the losses and gradients before the update (``check_finite``).
    A float32 model (its compute dtype) steps a CUDA batch under
    ``exact_float32()``, so that a card step is reproducible (with TF32
    convolutions and cuDNN's nondeterministic algorithms two card runs of
    the held-out gate at one seed differed by 9.5 strict bAP); bfloat16
    steps and CPU steps run as they are. ``draw_device``: where the step's
    generators draw (the batch's device by default); "cpu" draws on the
    host and copies each draw to the batch's device, so a card step
    samples what a CPU step samples."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    named = list(model.named_parameters())
    forward = forward or model.forward_train
    float32 = getattr(model, "dtype", params[0].dtype) == torch.float32

    def train_step(images, gt, step: int, meta=None):
        exact = float32 and images.image.device.type == "cuda"
        with exact_float32() if exact else contextlib.nullcontext():
            return run(images, gt, step, meta)

    def run(images, gt, step, meta):
        with span("train.forward"):
            if meta is not None and "target_hw" in meta:
                images = preprocess_batch(images, meta)
            device = images.image.device
            sampling, dropout = step_generators(seed, step,
                                                draw_device or device)
            losses = forward(images, gt, sampling, dropout)
            total = sum(v for k, v in losses.items()
                        if not k.startswith("metric/"))
        optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            total.backward()
        if debug_nans:
            check_finite(step, {**losses, "total_loss": total}, named)
        with span("train.optimizer"):
            if clip is not None:
                clip(params)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return mean_over_ranks(out)

    return train_step


class Trainer:
    """cfg -> a trained model. ``data``: an iterable of ``(ImageBatch,
    GTInstances[, meta])`` batches of CPU tensors, or None for
    ``build_detection_train_loader(cfg, seed=self.seed)``. ``device``
    overrides ``cfg.MODEL.DEVICE``; ``state_dict`` gives starting weights
    (else MODEL.WEIGHTS: a Caffe2 ``.pkl``, a detectron2 or this package's
    ``.pth`` or a JAX package ``.ckpt``, over weights from the seed).
    Under a process group each rank takes its rows of the caller's global
    batches (``parallel.local_rows``)."""

    def __init__(self, cfg, data: Optional[Iterable] = None, device=None,
                 state_dict=None):
        check_training_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg, device)
        self.data = data
        world = get_world_size()
        if cfg.SOLVER.IMS_PER_BATCH % world:
            raise ValueError(
                f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} must be "
                f"divisible by the world size {world}")
        if cfg.TPU.MODEL_PARALLEL > 1 and spans_machines():
            raise ValueError("TPU.MODEL_PARALLEL > 1 runs on one machine "
                             "only (a run across machines is data "
                             "parallel)")
        self.seed = default_setup(cfg)
        model = build_model(cfg)
        init_weights(model, torch.Generator().manual_seed(self.seed))
        if state_dict is not None:
            # keys the weights lack (a predictor removed by surgery) keep
            # their seeded values
            unexpected = model.load_state_dict(
                state_dict, strict=False).unexpected_keys
            if unexpected:
                raise ValueError(f"weights with no parameter: {unexpected}")
        else:
            # MODEL.WEIGHTS of any format; tensors it lacks, or holds in
            # another shape, keep their seeded values
            maybe_load_reference_weights(cfg.MODEL.WEIGHTS, model)
        self.model = model.to(self.device).train()
        # FSDP2 turns the parameters into shards: the optimizer comes after
        forward = wrap_model(self.model, cfg)
        self.optimizer = build_optimizer(cfg, self.model)
        self.scheduler = build_scheduler(cfg, self.optimizer)
        self.train_step = make_train_step(
            self.model, self.optimizer, self.scheduler,
            build_gradient_clipper(cfg), self.seed,
            debug_nans=cfg.TPU.DEBUG_NANS, forward=forward)
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR)
        self.metrics = MetricsLogger(rank_output_dir(cfg))
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.hooks = []  # callables hook(iteration), after each step
        self.last_losses = {}  # the latest step's, detached
        self.preempted = False

    def resume_or_load(self, resume: bool = True) -> None:
        """With ``resume``, restore the model, optimizer, scheduler and
        iteration from the newest checkpoint in OUTPUT_DIR, if any."""
        if not resume:
            return
        loaded = self.checkpointer.load_latest(
            map_location="cpu" if is_sharded(self.model) else self.device)
        if loaded is None:
            return
        load_training_state(self.model, self.optimizer, loaded)
        if "scheduler" in loaded:
            self.scheduler.load_state_dict(loaded["scheduler"])
        self.start_iter = int(loaded["iteration"]) + 1

    def _epochs(self, data):
        """The caller's iterable, over and over."""
        while True:
            empty = True
            for batch in data:
                empty = False
                yield batch
            if empty:
                raise ValueError("Trainer: the data iterable gave no batch")

    def train(self):
        """Run from ``start_iter`` to ``SOLVER.MAX_ITER``; returns the last
        step's losses."""
        cfg = self.cfg
        self.preempted = False
        loader = None
        if self.data is None:
            loader = build_detection_train_loader(
                cfg, seed=self.seed, rank=get_rank(),
                world_size=get_world_size(),
                pin_memory=self.device.type == "cuda")
        batches = device_batches(
            loader if loader is not None else
            map(local_rows, self._epochs(self.data)), self.device)

        def on_term(signum, frame):
            self.preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # not the main thread: no handler
            prev = None
        losses, it, t_last = {}, self.start_iter, time.time()
        profile_start = cfg.TPU.PROFILE_START_STEP
        profile_stop = profile_start + cfg.TPU.PROFILE_NUM_STEPS
        # a resume can land inside the window: only a trace this run
        # started is stopped
        profiler, done = None, it - 1
        try:
            while it < self.max_iter:
                if it == profile_start:
                    profiler = self._start_profile()
                with span("train.fetch"):
                    images, gt, meta = next(batches)
                losses = self.train_step(images, gt, it, meta)
                self.last_losses = losses
                if it % 20 == 0 or it == self.max_iter - 1:
                    now = time.time()
                    with span("train.log"):
                        self.metrics.log(
                            it, {**losses,
                                 "lr": self.optimizer.param_groups[0]["lr"],
                                 "time_since_last_log": now - t_last})
                    t_last = now
                period = cfg.SOLVER.CHECKPOINT_PERIOD
                if period > 0 and (it + 1) % period == 0:
                    self.save(it)
                for hook in self.hooks:
                    hook(it)
                done = it
                if profiler is not None and it + 1 == profile_stop:
                    self._stop_profile(profiler, it)
                    profiler = None
                # every rank stops after the same step
                self.preempted = any_rank(self.preempted)
                if self.preempted:
                    # a consistent post-step state: resume starts at it + 1
                    self.save(it)
                    break
                it += 1
            if not self.preempted:
                self.save(self.max_iter - 1, name="model_final")
        finally:
            if profiler is not None:  # the window ran past the last step
                self._stop_profile(profiler, done)
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)
            batches.close()
            if loader is not None:
                loader.close()
            self.checkpointer.wait()
        return losses

    def _start_profile(self):
        """A started ``torch.profiler`` of the host and, on CUDA, the
        card."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, last_step: int) -> None:
        """Stop ``profiler`` and write its trace under OUTPUT_DIR/profile."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = os.path.join(self.cfg.OUTPUT_DIR, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(
            out, f"trace_to_iter_{last_step:07d}.json"))

    def save(self, iteration: int, name=None) -> None:
        """Every rank calls it (FSDP2 gathers the shards); rank 0
        writes. A span ``train.checkpoint`` under ``torch.profiler``."""
        with span("train.checkpoint"):
            state = training_state(self.model, self.optimizer,
                                   self.scheduler, iteration)
            if not is_main_process():
                return
            name = name or f"model_{iteration:07d}"
            if self.cfg.TPU.ASYNC_CHECKPOINT:
                self.checkpointer.save_async(state, name)
            else:
                self.checkpointer.save(state, name)

    def inference_model(self):
        """The model to evaluate: the trained one, or under FSDP2 a whole
        copy of it on every rank (evaluation runs each rank's own batches,
        with no collective inside a forward)."""
        if not is_sharded(self.model):
            return self.model
        state = full_model_state(self.model)
        model = build_model(self.cfg)
        model.load_state_dict(state)
        return model.to(self.device).eval()

    def test(self, cfg=None):
        """Evaluate the model on cfg.DATASETS.TEST, as the CLI does
        (DefaultTrainer.test); returns {dataset: results}."""
        from ..cli import do_test

        return do_test(cfg or self.cfg, model=self.inference_model())
