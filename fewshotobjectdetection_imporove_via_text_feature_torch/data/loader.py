"""Batched fixed-shape data loaders, and the copy of their batches to the
device.

Counterpart of the JAX package's ``data/loader.py`` (ref
defrcn/dataloader/build.py: TrainingSampler / InferenceSampler and
aspect-ratio grouping): threads decode, batches are grouped by padded
bucket, and each comes out as ``(ImageBatch, GTInstances, meta)`` of CPU
tensors, in page-locked memory when ``pin_memory`` is set. The shuffle, the
per-item augmentation streams and the bucket grouping are the JAX
package's numpy code, so for one seed both packages give the same batches.

``device_batches`` moves batches to the device in the caller's thread: on
CUDA the copies are enqueued with ``non_blocking`` on a stream of their
own, so they can overlap the previous step's queued work on the current
stream, which waits for each batch's copy before it reads it.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List

import numpy as np
import torch

from ..structures import GTInstances, ImageBatch
from .catalog import DatasetCatalog
from .mapper import DatasetMapper

__all__ = [
    "get_detection_dataset_dicts",
    "repeat_factors_from_category_frequency",
    "build_detection_train_loader",
    "build_detection_test_loader",
    "device_batches",
    "Prefetcher",
]


def get_detection_dataset_dicts(names, filter_empty=True):
    if isinstance(names, str):
        names = [names]
    dicts = []
    for name in names:
        d = DatasetCatalog.get(name)
        if not len(d):
            raise ValueError(f"Dataset {name} is empty")
        dicts.extend(d)
    if filter_empty:
        dicts = [r for r in dicts if len(r.get("annotations", []))]
    return dicts


def repeat_factors_from_category_frequency(dicts, repeat_thresh: float):
    """Per-image repeat factors of LVIS repeat-factor sampling
    (DATALOADER.SAMPLER_TRAIN "RepeatFactorTrainingSampler"):
    f(c) = fraction of images with category c, r(c) = max(1, sqrt(t /
    f(c))), r(image) = the max over its categories."""
    n = len(dicts)
    rec_cats = [
        {a["category_id"] for a in rec.get("annotations", [])}
        for rec in dicts
    ]
    freq: Dict[object, int] = {}
    for cats in rec_cats:
        for cid in cats:
            freq[cid] = freq.get(cid, 0) + 1
    cat_rep = {
        cid: max(1.0, np.sqrt(repeat_thresh / (cnt / n)))
        for cid, cnt in freq.items()
    }
    return np.asarray(
        [max((cat_rep[cid] for cid in cats), default=1.0)
         for cats in rec_cats],
        np.float64,
    )


def _stack(arrays, pin_memory: bool) -> torch.Tensor:
    """np.stack into a CPU tensor, page-locked when ``pin_memory``."""
    if not pin_memory:
        return torch.from_numpy(np.stack(arrays))
    first = arrays[0]
    dtype = torch.from_numpy(np.zeros(0, first.dtype)).dtype
    out = torch.empty((len(arrays), *first.shape), dtype=dtype,
                      pin_memory=True)
    np.stack(arrays, out=out.numpy())
    return out


def _stack_batch(items: List[Dict], pin_memory: bool = False):
    images = ImageBatch(
        image=_stack([it["image"] for it in items], pin_memory),
        hw=_stack([it["hw"] for it in items], pin_memory),
        orig_hw=_stack([it["orig_hw"] for it in items], pin_memory),
    )
    gt = GTInstances(
        boxes=_stack([it["gt_boxes"] for it in items], pin_memory),
        classes=_stack([it["gt_classes"] for it in items], pin_memory),
        valid=_stack([it["gt_valid"] for it in items], pin_memory),
    )
    meta = {
        "image_ids": [it["image_id"] for it in items],
        "file_names": [it.get("file_name") for it in items],
        "valid_count": sum(1 for it in items if not it.get("_pad", False)),
    }
    if "short" in items[0]:  # TPU.DEVICE_PREPROCESS: the resize's draws
        meta["short"] = np.asarray([it["short"] for it in items], np.float32)
        meta["flip"] = np.asarray([it["flip"] for it in items], bool)
        meta["target_hw"] = items[0]["target_hw"]
        meta["max_size"] = items[0]["max_size"]
    return images, gt, meta


class Prefetcher:
    """Runs an iterator in a daemon thread with a small queue; an error in
    the thread is raised in the consumer. ``close`` stops the thread."""

    def __init__(self, gen_fn, maxsize=4):
        self._q = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._t = threading.Thread(
            target=self._run, args=(gen_fn,), daemon=True
        )
        self._t.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen_fn):
        try:
            for item in gen_fn():
                if not self._put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            self._put(e)
            return
        self._put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is StopIteration:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self, timeout: float = 60.0) -> None:
        """Stop the thread (it finishes the item in hand) and wait for it."""
        self._stop.set()
        self._t.join(timeout)


def build_detection_train_loader(
    cfg, dataset_names=None, *, seed: int = 0, prefetch: bool = True,
    batch_size: int = 0, rank: int = 0, world_size: int = 1,
    pin_memory: bool = False,
) -> Iterator:
    """Infinite shuffled loader of ``(ImageBatch, GTInstances, meta)``,
    batches grouped by image bucket.

    Every rank runs the same seeded shuffle and the same metadata-only
    bucket grouping (``DatasetMapper.plan`` needs no pixels), so all ranks
    agree on every global batch, and rank r decodes its contiguous
    ``batch_size / world_size`` slice of each."""
    names = dataset_names or cfg.DATASETS.TRAIN
    dicts = get_detection_dataset_dicts(
        names, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
    )
    mapper = DatasetMapper.from_config(cfg, is_train=True)
    batch_size = batch_size or cfg.SOLVER.IMS_PER_BATCH
    if batch_size % world_size:
        raise ValueError(f"batch {batch_size} is not divisible by the "
                         f"world size {world_size}")
    local = batch_size // world_size
    num_workers = max(1, int(cfg.DATALOADER.NUM_WORKERS))

    sampler_name = cfg.DATALOADER.SAMPLER_TRAIN
    if sampler_name == "TrainingSampler":
        repeat_factors = None
    elif sampler_name == "RepeatFactorTrainingSampler":
        repeat_factors = repeat_factors_from_category_frequency(
            dicts, cfg.DATALOADER.REPEAT_THRESHOLD
        )
    else:
        raise ValueError(f"Unknown training sampler: {sampler_name}")

    def plans():
        """The global stream of (epoch, index, plan), the same on every
        rank; each item's draws come from a stream of its own."""
        rng = np.random.RandomState(seed)
        for epoch in itertools.count():
            if repeat_factors is None:
                order = rng.permutation(len(dicts))
            else:
                # d2 RepeatFactorTrainingSampler._get_epoch_indices:
                # stochastic rounding of the fractional part, then a shuffle
                rounds = np.floor(repeat_factors).astype(np.int64) + (
                    rng.random_sample(len(dicts))
                    < (repeat_factors - np.floor(repeat_factors))
                )
                order = rng.permutation(
                    np.repeat(np.arange(len(dicts)), rounds)
                )
            occ: Dict[int, int] = {}
            for i in order:
                # a SeedSequence of (seed, epoch, index[, repeat]): items
                # never share a stream across epochs, and a repeat of an
                # item within an epoch draws afresh
                k = occ.get(int(i), 0)
                occ[int(i)] = k + 1
                key = [seed, epoch, int(i)] + ([k] if k else [])
                r = np.random.RandomState(
                    np.random.MT19937(np.random.SeedSequence(key))
                )
                yield epoch, int(i), mapper.plan(dicts[int(i)], r)

    def global_batches():
        groups: Dict[tuple, List] = {}
        for epoch, i, plan in plans():
            key = plan["bucket"]
            groups.setdefault(key, []).append((epoch, i, plan))
            if len(groups[key]) == batch_size:
                yield groups.pop(key)

    def generate():
        def load(args):
            _, i, plan = args
            return mapper(dicts[i], None, plan)

        # a few batches' decodes in flight keep the workers busy across
        # batch boundaries
        window = 3
        with ThreadPoolExecutor(num_workers) as pool:
            gb = global_batches()
            pending = deque()

            def submit_next():
                batch = next(gb)
                mine = batch[rank * local : (rank + 1) * local]
                pending.append([pool.submit(load, a) for a in mine])

            for _ in range(window):
                submit_next()
            while True:
                futs = pending.popleft()
                items = [f.result() for f in futs]
                submit_next()
                yield _stack_batch(items, pin_memory)

    return Prefetcher(generate) if prefetch else generate()


def build_detection_test_loader(
    cfg, dataset_name: str, batch_size: int = 1, *, prefetch: bool = True,
    pin_memory: bool = False, shard=None,
) -> Iterator:
    """Sequential loader over the whole test set, batches grouped by
    bucket; a group's last partial batch is padded with copies of its last
    record, and ``meta['valid_count']`` counts the real ones.

    ``shard=(rank, world)``: every rank builds the same batch sequence from
    the metadata-only plans, batch k is rank ``k % world``'s, and a foreign
    batch comes out as ``(None, None, {"skip": True, "valid_count": 0})``
    and is never decoded (the JAX package's contract, ref InferenceSampler,
    dataloader/build.py:385)."""
    dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False)
    mapper = DatasetMapper.from_config(cfg, is_train=False)
    num_workers = max(1, int(cfg.DATALOADER.NUM_WORKERS))

    def generate():
        plans = [mapper.plan(r, np.random.RandomState(i))
                 for i, r in enumerate(dicts)]
        groups: Dict[tuple, List] = {}
        batches: List[List] = []
        for i, p in enumerate(plans):
            key = p["bucket"]
            groups.setdefault(key, []).append((i, p, False))
            if len(groups[key]) == batch_size:
                batches.append(groups.pop(key))
        for items in groups.values():
            while len(items) < batch_size:
                j, p, _ = items[-1]
                items.append((j, p, True))  # pad: a copy of the last record
            batches.append(items)

        def load(arg):
            i, plan, is_pad = arg
            item = mapper(dicts[i], None, plan)
            if is_pad:
                item["_pad"] = True
            return item

        rank, world = shard if shard is not None else (0, 1)

        def take(futures):
            if futures is None:  # another rank's batch
                return None, None, {"skip": True, "valid_count": 0}
            return _stack_batch([f.result() for f in futures], pin_memory)

        # enough batches in flight to keep every worker busy
        window = max(3, -(-2 * num_workers // batch_size))
        with ThreadPoolExecutor(num_workers) as pool:
            submitted = deque()
            for k, batch in enumerate(batches):
                submitted.append([pool.submit(load, a) for a in batch]
                                 if k % world == rank else None)
                if len(submitted) < window:
                    continue
                yield take(submitted.popleft())
            while submitted:
                yield take(submitted.popleft())

    return Prefetcher(generate) if prefetch else generate()


def device_batches(batches: Iterable, device):
    """``(images, gt[, meta])`` batches of CPU tensors -> ``(images, gt,
    meta)`` on ``device``, copied in the caller's thread as each batch is
    taken. On CUDA the copies are enqueued ``non_blocking`` (from
    page-locked memory when the loader pinned it) on a stream of their own,
    so they can run beside the previous step's queued work; the current
    stream waits for them before the batch's first use. A sharded test
    loader's foreign batch (``images`` None) passes through as it is."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    for batch in batches:
        images, gt = batch[0], batch[1]
        meta = batch[2] if len(batch) > 2 else {}
        if images is None:
            yield None, None, meta
            continue
        if stream is None:
            yield images.to(device), gt.to(device), meta
            continue
        current = torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            images = images.to(device, non_blocking=True)
            gt = gt.to(device, non_blocking=True)
        current.wait_stream(stream)
        # the copies' memory now belongs to the current stream too
        for t in (*vars(images).values(), *vars(gt).values()):
            t.record_stream(current)
        yield images, gt, meta
