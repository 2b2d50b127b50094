"""Dataset mapper: a file record -> a fixed-shape numpy training example.

Counterpart of the JAX package's ``data/mapper.py`` (ref
defrcn/dataloader/dataset_mapper.py): reads the image with its EXIF
orientation applied, applies RandomCrop when INPUT.CROP is on (train only,
before the resize), ResizeShortestEdge (a draw from the sizes at train, the
fixed size at test) and the random horizontal flip, moves the boxes with
the pixels, then pads the image to the smallest covering bucket and the GT
to ``TPU.MAX_GT`` slots, so that batches come in a few fixed shapes.

The JAX package's ``TPU.HOST_SPACE_TO_DEPTH`` (a layout for its
space-to-depth stem) has no counterpart: this package's stem is a plain
7x7/2 convolution. With ``TPU.DEVICE_PREPROCESS`` the mapper emits the raw
pixels in a source bucket and leaves the resize and the flip to the device
(``data/device_preprocess.py``). PIL is imported where an image is read,
not with this module.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = [
    "DatasetMapper",
    "crop_boxes",
    "pick_bucket",
    "random_crop_plan",
    "random_crop_size",
    "resize_shortest_edge_size",
]


def _open_oriented(file_name: str):
    """Open an image with its EXIF orientation applied, as the reference's
    read_image does. Returns (img, oriented): the tag is read from the lazy
    header and the pixels are transposed only for a rotated file;
    ``oriented`` says the stored pixels differ from the displayed ones, so
    the native decode (stored pixels) must not be used."""
    from PIL import Image

    img = Image.open(file_name)  # header only (lazy decode)
    try:
        orientation = img.getexif().get(0x0112, 1)
    except Exception:  # a malformed EXIF block: no orientation
        orientation = 1
    if orientation == 1:
        return img, False
    from PIL import ImageOps

    return ImageOps.exif_transpose(img), True


def resize_shortest_edge_size(h, w, short, max_size):
    """detectron2 ResizeShortestEdge.get_output_shape semantics."""
    scale = short / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        scale2 = max_size / max(newh, neww)
        newh, neww = newh * scale2, neww * scale2
    return int(newh + 0.5), int(neww + 0.5)


def random_crop_size(crop_type: str, crop_size, h: int, w: int, rng):
    """d2 RandomCrop.get_crop_size: the (ch, cw) crop extent of an (h, w)
    image; the *_range types draw from ``rng``, the item's own stream."""
    if crop_type == "relative":
        fh, fw = crop_size
        return int(h * fh + 0.5), int(w * fw + 0.5)
    if crop_type == "relative_range":
        lo = np.asarray(crop_size, dtype=np.float32)
        fh, fw = lo + rng.rand(2).astype(np.float32) * (1 - lo)
        return int(h * fh + 0.5), int(w * fw + 0.5)
    if crop_type == "absolute":
        return min(int(crop_size[0]), h), min(int(crop_size[1]), w)
    if crop_type == "absolute_range":
        if crop_size[0] > crop_size[1]:
            raise ValueError(f"absolute_range needs lo <= hi: {crop_size}")
        ch = rng.randint(min(h, int(crop_size[0])), min(h, int(crop_size[1])) + 1)
        cw = rng.randint(min(w, int(crop_size[0])), min(w, int(crop_size[1])) + 1)
        return int(ch), int(cw)
    raise ValueError(f"Unknown INPUT.CROP.TYPE: {crop_type!r}")


def random_crop_plan(crop_type: str, crop_size, h: int, w: int, rng):
    """d2 RandomCrop.get_transform: the crop extent, then a uniform offset;
    returns (y0, x0, ch, cw). The draw order (size, y0, x0) is fixed."""
    ch, cw = random_crop_size(crop_type, crop_size, h, w, rng)
    if not (h >= ch and w >= cw):
        raise ValueError(f"crop ({ch}, {cw}) larger than image ({h}, {w})")
    y0 = int(rng.randint(h - ch + 1))
    x0 = int(rng.randint(w - cw + 1))
    return y0, x0, ch, cw


def crop_boxes(boxes: np.ndarray, y0, x0, ch, cw) -> np.ndarray:
    """d2 CropTransform.apply_box and the annotation clip: XYXY boxes moved
    into the crop frame and clipped to it (callers drop the empty ones)."""
    shifted = boxes - np.array([x0, y0, x0, y0], np.float32)
    shifted[:, 0::2] = shifted[:, 0::2].clip(0, cw)
    shifted[:, 1::2] = shifted[:, 1::2].clip(0, ch)
    return shifted


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]):
    """Smallest bucket (by area) covering (h, w); orientation-aware (both
    (a, b) and (b, a) are considered). Falls back to round-up-to-64."""
    cands = []
    for bh, bw in buckets:
        for ch, cw in ((bh, bw), (bw, bh)):
            if ch >= h and cw >= w:
                cands.append((ch * cw, ch, cw))
    if cands:
        _, bh, bw = min(cands)
        return bh, bw
    up = lambda v: int(math.ceil(v / 64.0) * 64)  # noqa: E731
    return up(h), up(w)


class DatasetMapper:
    """record + ``RandomState`` -> one padded example (numpy)."""

    def __init__(
        self,
        is_train: bool,
        min_size,
        max_size: int,
        buckets: Sequence[Tuple[int, int]],
        max_gt: int = 100,
        image_format: str = "BGR",
        random_flip: bool = True,
        native_io: bool = True,
        sampling: str = "choice",
        crop=None,
        device_preprocess: bool = False,
        raw_buckets: Sequence[Tuple[int, int]] = (),
    ):
        self.is_train = is_train
        self.min_sizes = (
            list(min_size) if isinstance(min_size, (list, tuple)) else [min_size]
        )
        # d2 ResizeShortestEdge sample_style: "choice" draws one of the
        # sizes, "range" draws uniformly from [min, max]
        if sampling not in ("choice", "range"):
            raise ValueError(f"Unknown MIN_SIZE_TRAIN_SAMPLING: {sampling!r}")
        if sampling == "range" and (
            len(self.min_sizes) != 2 or self.min_sizes[0] > self.min_sizes[1]
        ):
            raise ValueError(
                "range sampling needs MIN_SIZE_TRAIN = (min, max) with "
                f"min <= max, got {tuple(self.min_sizes)!r}"
            )
        self.sampling = sampling
        self.max_size = max_size
        self.buckets = list(buckets)
        self.max_gt = max_gt
        self.image_format = image_format
        self.random_flip = random_flip and is_train
        self.native_io = native_io
        # TPU.DEVICE_PREPROCESS: emit raw pixels in a source bucket
        # (``raw_buckets``, else ``buckets``) and the resize plan; the
        # resize and flip run on the device (data/device_preprocess.py)
        self.device_preprocess = device_preprocess
        self.raw_buckets = list(raw_buckets)
        # INPUT.CROP: (type, size) or None; train only, before the resize
        self.crop = None
        if crop is not None and is_train:
            ctype, csize = crop
            if ctype not in (
                "relative", "relative_range", "absolute", "absolute_range"
            ):
                raise ValueError(f"Unknown INPUT.CROP.TYPE: {ctype!r}")
            if ctype == "absolute_range" and csize[0] > csize[1]:
                raise ValueError(f"absolute_range needs lo <= hi: {csize}")
            self.crop = (ctype, tuple(csize))

    @classmethod
    def from_config(cls, cfg, is_train: bool):
        """The mapper of the train or test loader for ``cfg``."""
        common = dict(
            max_gt=cfg.TPU.MAX_GT, buckets=cfg.TPU.IMAGE_BUCKETS,
            image_format=cfg.INPUT.FORMAT,
            native_io=cfg.DATALOADER.NATIVE_IO,
            device_preprocess=cfg.TPU.DEVICE_PREPROCESS,
            raw_buckets=cfg.TPU.RAW_BUCKETS,
        )
        if not is_train:
            return cls(False, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST,
                       random_flip=False, **common)
        return cls(
            True, cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN,
            random_flip=cfg.INPUT.RANDOM_FLIP == "horizontal",
            sampling=cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING,
            crop=((cfg.INPUT.CROP.TYPE, tuple(cfg.INPUT.CROP.SIZE))
                  if cfg.INPUT.CROP.ENABLED else None),
            **common,
        )

    def plan(self, record: Dict, rng: np.random.RandomState) -> Dict:
        """The draws of one example (crop, short edge, flip) and its bucket,
        from the record's metadata, without the pixels. ``__call__`` with
        this plan decodes; the loader groups batches by plan."""
        h0 = record.get("height")
        w0 = record.get("width")
        if h0 is None or w0 is None:  # metadata missing: read the header
            from PIL import Image

            with Image.open(record["file_name"]) as img:
                w0, h0 = img.size
                # the displayed size: orientations 5-8 transpose it
                try:
                    if img.getexif().get(0x0112, 1) in (5, 6, 7, 8):
                        w0, h0 = h0, w0
                except Exception:  # a malformed EXIF block
                    pass
        crop = None
        ch, cw = h0, w0
        if self.crop is not None:  # crop first: resize sees its extent
            crop = random_crop_plan(self.crop[0], self.crop[1], h0, w0, rng)
            ch, cw = crop[2], crop[3]
        if not self.is_train:
            short = self.min_sizes[0]
        elif self.sampling == "range":
            short = int(rng.randint(self.min_sizes[0], self.min_sizes[1] + 1))
        else:
            short = self.min_sizes[rng.randint(len(self.min_sizes))]
        flip = bool(self.random_flip and rng.rand() < 0.5)
        nh, nw = resize_shortest_edge_size(ch, cw, short, self.max_size)
        bucket = pick_bucket(nh, nw, self.buckets)
        if self.device_preprocess:  # (source bucket, target bucket)
            bucket = (*pick_bucket(ch, cw, self.raw_buckets or self.buckets),
                      *bucket)
        return {"short": short, "flip": flip, "bucket": bucket, "crop": crop}

    def __call__(self, record: Dict, rng: np.random.RandomState,
                 plan: Dict = None):
        if plan is None:
            plan = self.plan(record, rng)
        if self.device_preprocess:
            return self._call_raw(record, plan)
        return self._call_host(record, plan)

    @staticmethod
    def _check_crop_fits(record: Dict, cropplan, h0: int, w0: int):
        """A crop planned from stale height/width metadata must not slice
        past the decoded pixels (a slice would shrink silently)."""
        y0, x0, ch, cw = cropplan
        if y0 + ch > h0 or x0 + cw > w0:
            raise ValueError(
                f"{record['file_name']}: decoded size ({h0}, {w0}) is "
                f"smaller than the planned crop {tuple(cropplan)} — fix "
                f"the dataset's height/width fields"
            )

    def _gt_arrays(self, boxes, classes):
        g = self.max_gt
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_classes = np.zeros((g,), np.int32)
        gt_valid = np.zeros((g,), bool)
        n = min(len(boxes), g)
        gt_boxes[:n] = boxes[:n]
        gt_classes[:n] = classes[:n]
        gt_valid[:n] = True
        return gt_boxes, gt_classes, gt_valid

    def _call_raw(self, record: Dict, plan: Dict):
        """TPU.DEVICE_PREPROCESS: the raw pixels (cropped on the host, a
        free uint8 slice) zero-padded into their source bucket, the resized
        size as ``hw``, the crop extent as ``orig_hw``, the GT boxes as the
        device's resize and flip will place them, and the draws."""
        from .device_preprocess import scale_boxes

        img, _ = _open_oriented(record["file_name"])
        arr = np.asarray(img.convert("RGB"), np.uint8)
        h0, w0 = arr.shape[:2]
        if self.image_format == "BGR":
            arr = arr[:, :, ::-1]
        annos = record.get("annotations", [])
        boxes = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
        classes = np.array(
            [a["category_id"] for a in annos], np.int64).reshape(-1)
        cropplan = plan.get("crop")
        if cropplan is not None:
            self._check_crop_fits(record, cropplan, h0, w0)
            y0, x0, ch, cw = cropplan
            arr = arr[y0: y0 + ch, x0: x0 + cw]
            h0, w0 = ch, cw
            if len(boxes):
                boxes = crop_boxes(boxes, y0, x0, ch, cw)
        short, flip = plan["short"], plan["flip"]
        nh, nw = resize_shortest_edge_size(h0, w0, short, self.max_size)
        if len(boxes):
            boxes = scale_boxes(boxes, (h0, w0), (nh, nw), flip)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, classes = boxes[keep], classes[keep]
        rbh, rbw = pick_bucket(h0, w0, self.raw_buckets or self.buckets)
        tbh, tbw = pick_bucket(nh, nw, self.buckets)
        if plan["bucket"] != (rbh, rbw, tbh, tbw):
            raise ValueError(
                f"{record['file_name']}: decoded size ({h0}, {w0}) maps to "
                f"bucket {(rbh, rbw, tbh, tbw)} but the record metadata "
                f"planned {plan['bucket']} — fix the dataset's height/width")
        raw = np.zeros((rbh, rbw, 3), np.uint8)
        raw[:h0, :w0] = arr
        gt_boxes, gt_classes, gt_valid = self._gt_arrays(boxes, classes)
        return {
            "image": raw,
            "hw": np.array([nh, nw], np.int32),
            "orig_hw": np.array([h0, w0], np.int32),
            "bucket": (rbh, rbw, tbh, tbw),
            "target_hw": (tbh, tbw),
            "short": np.float32(short),
            "max_size": self.max_size,
            "flip": flip,
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "image_id": record.get("image_id"),
            "file_name": record.get("file_name"),
        }

    def _call_host(self, record: Dict, plan: Dict):
        from PIL import Image

        img, oriented = _open_oriented(record["file_name"])
        w0, h0 = img.size

        cropplan = plan.get("crop")
        if cropplan is not None:
            self._check_crop_fits(record, cropplan, h0, w0)
        eh, ew = (cropplan[2], cropplan[3]) if cropplan else (h0, w0)

        short = plan["short"]
        h, w = resize_shortest_edge_size(eh, ew, short, self.max_size)
        flipped = plan["flip"]
        bh, bw = pick_bucket(h, w, self.buckets)
        if plan["bucket"] != (bh, bw):
            # batches are grouped by the metadata's bucket
            raise ValueError(
                f"{record['file_name']}: decoded size ({h0}, {w0}) maps to "
                f"bucket {(bh, bw)} but the record metadata planned "
                f"{plan['bucket']} — fix the dataset's height/width fields"
            )

        padded = None
        # the native core decodes stored pixels and has no crop stage: a
        # rotated file or a crop goes through PIL
        if self.native_io and not oriented and cropplan is None:
            from . import native_io

            res = native_io.load_image(
                record["file_name"], short, self.max_size, (bh, bw),
                flip=flipped, bgr=self.image_format == "BGR",
            )
            if res is not None:
                canvas, new_hw, _ = res
                padded = np.clip(canvas + 0.5, 0, 255).astype(np.uint8)
                h, w = int(new_hw[0]), int(new_hw[1])

        if padded is None:  # PIL: native off or unavailable, crop, rotation
            img = img.convert("RGB")
            if cropplan is not None:
                y0, x0, ch, cw = cropplan
                img = img.crop((x0, y0, x0 + cw, y0 + ch))
            if (h, w) != (eh, ew):
                img = img.resize((w, h), Image.BILINEAR)
            arr = np.asarray(img, np.uint8)
            if self.image_format == "BGR":
                arr = arr[:, :, ::-1]
            if flipped:
                arr = arr[:, ::-1, :]
            padded = np.zeros((bh, bw, 3), np.uint8)
            padded[:h, :w] = arr

        sx, sy = w / ew, h / eh
        annos = record.get("annotations", [])
        boxes = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
        classes = np.array(
            [a["category_id"] for a in annos], np.int64
        ).reshape(-1)
        if cropplan is not None and len(boxes):
            y0, x0, ch, cw = cropplan
            boxes = crop_boxes(boxes, y0, x0, ch, cw)
        boxes = boxes * np.array([sx, sy, sx, sy], np.float32)

        if flipped and len(boxes):
            x1 = w - boxes[:, 2]
            x2 = w - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)

        # clip, then drop the empty boxes (filter_empty_instances)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, classes = boxes[keep], classes[keep]

        gt_boxes, gt_classes, gt_valid = self._gt_arrays(boxes, classes)
        return {
            "image": padded,
            "hw": np.array([h, w], np.int32),
            "orig_hw": np.array([h0, w0], np.int32),
            "bucket": (bh, bw),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "image_id": record.get("image_id"),
            "file_name": record.get("file_name"),
            "flipped": flipped,
        }
