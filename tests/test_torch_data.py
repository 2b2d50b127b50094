"""The port's data path against the JAX package's, on the CPU: the
synthetic VOC maker, the dataset registry, the mapper, the train and test
loaders, the native decode binding and the device feeder.

Every comparison here is exact (arrays equal, bit for bit): both packages
run the same numpy draws, the same PIL calls and the same native core.
"""

import os
import runpy
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    get_cfg as jax_get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data import (
    DatasetCatalog as JaxDatasetCatalog,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.builtin_meta import (
    _get_builtin_metadata as jax_builtin_metadata,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.loader import (
    build_detection_test_loader as jax_test_loader,
    build_detection_train_loader as jax_train_loader,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.mapper import (
    DatasetMapper as JaxMapper,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.meta_voc import (
    load_filtered_voc_instances as jax_load_voc,
    register_meta_voc as jax_register_meta_voc,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data import (
    native_io as jax_native_io,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    DatasetCatalog,
    DatasetMapper,
    build_detection_test_loader,
    build_detection_train_loader,
    device_batches,
    get_detection_dataset_dicts,
    register_all,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    native_io,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
    preprocess_batch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.builtin_meta import (
    PASCAL_VOC_ALL_CATEGORIES,
    PASCAL_VOC_BASE_CATEGORIES,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.loader import (
    Prefetcher,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
    make_voc,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's catalog is process-wide: this file's names are its own
PREFIX = "torchdata_"


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """One synthetic VOC (8 images a year, 1- and 2-shot splits of seeds
    0-1), registered under the built-in names in the port and under
    PREFIX names in the JAX package."""
    root = str(tmp_path_factory.mktemp("voc"))
    make_voc(root, images=8, shots=(1, 2), seeds=(0, 1))
    register_all(root)
    meta = jax_builtin_metadata("voc_fewshot")
    for name, year, split, keep in (
        ("voc_2007_trainval_base1", 2007, "trainval", "base1"),
        ("voc_2012_trainval_base1", 2012, "trainval", "base1"),
        ("voc_2007_test_all1", 2007, "test", "base_novel_1"),
        ("voc_2007_trainval_all1_1shot_seed0", 2007,
         "all_1shot_split_1_trainval", "base_novel_1"),
        ("voc_2007_trainval_all1_2shot_seed1", 2007,
         "all_2shot_split_1_trainval", "base_novel_1"),
    ):
        if PREFIX + name not in JaxDatasetCatalog:
            jax_register_meta_voc(PREFIX + name, meta,
                                  os.path.join(root, f"VOC{year}"), split,
                                  year, keep, 1, root=root)
    return root


def _tiny(cfg):
    """Small shapes: two buckets, two train sizes, batch 2."""
    cfg.INPUT.MIN_SIZE_TRAIN = (160, 224)
    cfg.INPUT.MAX_SIZE_TRAIN = 320
    cfg.INPUT.MIN_SIZE_TEST = 160
    cfg.INPUT.MAX_SIZE_TEST = 320
    cfg.TPU.IMAGE_BUCKETS = ((160, 224), (224, 320))
    cfg.TPU.MAX_GT = 10
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.DATALOADER.NUM_WORKERS = 2
    if "HOST_SPACE_TO_DEPTH" in cfg.TPU:  # the JAX package's TPU layout
        cfg.TPU.HOST_SPACE_TO_DEPTH = False
    return cfg


def _assert_batches_equal(ours, ref):
    images, gt, meta = ours
    jimages, jgt, jmeta = ref
    for name in ("image", "hw", "orig_hw"):
        np.testing.assert_array_equal(getattr(images, name).numpy(),
                                      np.asarray(getattr(jimages, name)),
                                      err_msg=name)
    for name in ("boxes", "classes", "valid"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(jgt, name)),
                                      err_msg=name)
    assert meta == {k: jmeta[k] for k in meta}


def test_synthetic_maker_writes_what_the_repository_tool_writes(tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    make_voc(str(ours), images=5, shots=(1, 3), seeds=(0, 2))
    argv = sys.argv
    sys.argv = ["_make_synthetic_voc.py", "--root", str(ref), "--images", "5",
                "--shots", "1", "3", "--seed", "0", "2"]
    try:
        runpy.run_path(os.path.join(ROOT, "tools", "_make_synthetic_voc.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    files = sorted(str(p.relative_to(ref)) for p in ref.rglob("*")
                   if p.is_file())
    assert files == sorted(str(p.relative_to(ours)) for p in ours.rglob("*")
                           if p.is_file())
    assert len([f for f in files if f.endswith(".xml")]) == 10
    assert len([f for f in files if f.endswith("_train.txt")]) == 80
    for f in files:  # XML, image sets, split files and the JPEGs
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f


def test_maker_image_size_option_writes_photo_like_images(tmp_path):
    make_voc(str(tmp_path), images=2, image_size=(500, 375))
    img = Image.open(tmp_path / "VOC2012" / "JPEGImages" / "000001.jpg")
    assert img.size == (500, 375)
    text = (tmp_path / "VOC2007" / "Annotations" / "000000.xml").read_text()
    assert "<width>500</width><height>375</height>" in text


@pytest.mark.parametrize("name,dirname,split,classes", [
    ("voc_2007_trainval_base1", "VOC2007", "trainval",
     PASCAL_VOC_BASE_CATEGORIES[1]),
    ("voc_2012_trainval_base1", "VOC2012", "trainval",
     PASCAL_VOC_BASE_CATEGORIES[1]),
    ("voc_2007_test_all1", "VOC2007", "test", PASCAL_VOC_ALL_CATEGORIES[1]),
    ("voc_2007_trainval_all1_1shot_seed0", "VOC2007",
     "all_1shot_split_1_trainval", PASCAL_VOC_ALL_CATEGORIES[1]),
    ("voc_2007_trainval_all1_2shot_seed1", "VOC2007",
     "all_2shot_split_1_trainval", PASCAL_VOC_ALL_CATEGORIES[1]),
])
def test_registry_dicts_equal_the_jax_package(voc, name, dirname, split,
                                              classes):
    ours = DatasetCatalog.get(name)
    ref = jax_load_voc(name, os.path.join(voc, dirname), split, classes,
                       root=voc)
    assert ours == ref
    assert ours and any(r["annotations"] for r in ours)
    assert ours == JaxDatasetCatalog.get(PREFIX + name)  # same loader


def test_registry_refuses_coco_and_can_move_its_root(voc, tmp_path):
    """The COCO names load (a synthetic COCO under another root; the name
    is kept from when COCO was refused), and the names follow the root."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_coco import (
        make_coco,
    )

    with pytest.raises(FileNotFoundError):  # no COCO under the VOC root
        DatasetCatalog.get("coco14_trainval_all")
    make_coco(str(tmp_path), train_images=4, test_images=2,
              image_size=(64, 48))
    register_all(str(tmp_path))  # another root: the names follow it
    try:
        records = DatasetCatalog.get("coco14_trainval_all")
        assert [r["image_id"] for r in records] == [1, 2, 3, 4]
        assert all(len(r["annotations"]) == 3 for r in records)
        assert len(DatasetCatalog.get("coco14_test_base")) == 2
        with pytest.raises(FileNotFoundError):
            DatasetCatalog.get("voc_2007_trainval_base1")
    finally:
        register_all(voc)
    assert DatasetCatalog.get("voc_2007_trainval_base1")


def _mapper_pair(is_train, **kw):
    return (DatasetMapper(is_train, **kw),
            JaxMapper(is_train, host_s2d=False, **kw))


@pytest.mark.parametrize("case", ["choice_flip", "range_crop", "test",
                                  "native"])
def test_mapper_output_equals_the_jax_mapper(voc, case):
    common = dict(max_size=320, buckets=((160, 224), (224, 320)), max_gt=10,
                  native_io=case == "native")
    if case == "test":
        ours, ref = _mapper_pair(False, min_size=160, random_flip=False,
                                 **common)
    elif case == "range_crop":
        ours, ref = _mapper_pair(True, min_size=(150, 230), sampling="range",
                                 crop=("relative_range", (0.5, 0.6)),
                                 **common)
    else:
        ours, ref = _mapper_pair(True, min_size=(160, 200, 224), **common)
    records = DatasetCatalog.get("voc_2007_test_all1")
    flips = 0
    for k, rec in enumerate(records):
        a = ours(rec, np.random.RandomState(k))
        b = ref(rec, np.random.RandomState(k))
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)
        flips += a["flipped"]
        assert a["gt_valid"].any()
    if case != "test":
        assert 0 < flips < len(records)


def test_mapper_applies_exif_orientation_like_the_jax_mapper(tmp_path):
    """A file stored landscape with orientation 6 (rotate 90) is read
    portrait; the record leaves height/width out, so the plan reads the
    header. Both mappers decode it with PIL, natively off or on."""
    rng = np.random.RandomState(3)
    exif = Image.Exif()
    exif[0x0112] = 6
    path = str(tmp_path / "rotated.jpg")
    Image.fromarray(rng.randint(0, 255, (150, 200, 3), np.uint8)).save(
        path, exif=exif)
    rec = {"file_name": path, "image_id": "rotated",
           "annotations": [{"category_id": 1, "bbox": [5.0, 7.0, 90.0, 120.0]}]}
    ours, ref = _mapper_pair(True, min_size=(160,), max_size=320,
                             buckets=((160, 224),), max_gt=4)
    a = ours(rec, np.random.RandomState(0))
    b = ref(rec, np.random.RandomState(0))
    assert tuple(a["orig_hw"]) == (200, 150)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


def test_native_binding_decodes_like_the_jax_binding(voc):
    path = os.path.join(voc, "VOC2007", "JPEGImages", "000003.jpg")
    ours = native_io.load_image(path, 160, 320, (224, 320), flip=True)
    ref = jax_native_io.load_image(path, 160, 320, (224, 320), flip=True)
    assert ours is not None and ref is not None
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert native_io.library_path().parent.name == "torch_kernels"
    # a file the core cannot decode gives None: the mapper then uses PIL
    png = os.path.join(voc, "not_a_jpeg.jpg")
    Image.new("RGB", (40, 30)).save(png, format="PNG")
    assert native_io.load_image(png, 160, 320, (224, 320)) is None


@pytest.mark.parametrize("sampler", ["TrainingSampler",
                                     "RepeatFactorTrainingSampler"])
def test_train_loader_batches_equal_the_jax_loader(voc, sampler):
    names = ("voc_2007_trainval_base1", "voc_2012_trainval_base1")
    cfg, jcfg = _tiny(get_cfg()), _tiny(jax_get_cfg())
    for c in (cfg, jcfg):
        c.DATALOADER.SAMPLER_TRAIN = sampler
        c.DATALOADER.REPEAT_THRESHOLD = 0.3
    ours = build_detection_train_loader(cfg, names, seed=11)
    ref = jax_train_loader(jcfg, tuple(PREFIX + n for n in names), seed=11)
    shapes = set()
    try:
        for _ in range(6):
            a, b = next(ours), next(ref)
            _assert_batches_equal(a, b)
            assert a[0].image.dtype == torch.uint8
            shapes.add(tuple(a[0].image.shape))
    finally:
        ours.close()
    assert len(shapes) == 2  # both buckets came up


def test_train_loader_slices_a_global_batch_by_rank(voc):
    cfg = _tiny(get_cfg())
    cfg.SOLVER.IMS_PER_BATCH = 4
    names = ("voc_2007_trainval_base1",)
    full = build_detection_train_loader(cfg, names, seed=2, prefetch=False)
    halves = [build_detection_train_loader(cfg, names, seed=2, rank=r,
                                           world_size=2, prefetch=False)
              for r in (0, 1)]
    for _ in range(3):
        images, _, meta = next(full)
        (a, _, ma), (b, _, mb) = next(halves[0]), next(halves[1])
        assert ma["image_ids"] + mb["image_ids"] == meta["image_ids"]
        assert torch.equal(torch.cat([a.image, b.image]), images.image)


def test_test_loader_pads_the_tail_like_the_jax_loader(voc):
    cfg, jcfg = _tiny(get_cfg()), _tiny(jax_get_cfg())
    ours = list(build_detection_test_loader(cfg, "voc_2007_test_all1",
                                            batch_size=3))
    ref = list(jax_test_loader(jcfg, PREFIX + "voc_2007_test_all1",
                               batch_size=3))
    assert len(ours) == len(ref) == 3  # 8 images in one bucket: 3 + 3 + 2
    assert [m["valid_count"] for _, _, m in ours] == [3, 3, 2]
    for a, b in zip(ours, ref):
        _assert_batches_equal(a, b)
    # the padded slot is a copy of the group's last image
    images = ours[-1][0].image
    assert torch.equal(images[2], images[1])


def test_get_detection_dataset_dicts_filters_empty_records(voc):
    names = ("voc_2007_trainval_base1",)
    kept = get_detection_dataset_dicts(names)
    every = get_detection_dataset_dicts(names, filter_empty=False)
    assert len(every) == 8 and 0 < len(kept) <= len(every)
    assert all(r["annotations"] for r in kept)


def test_device_preprocess_raises_naming_its_roadmap_item(voc):
    """TPU.DEVICE_PREPROCESS (ROADMAP item 14) is ported: the train loader
    gives the JAX loader's raw batches (raw pixels in a source bucket, the
    resized hw, the GT where the device resize puts it) and the resize's
    draws in meta, and ``preprocess_batch`` resizes them into the target
    bucket."""
    names = ("voc_2007_trainval_base1", "voc_2012_trainval_base1")
    cfg, jcfg = _tiny(get_cfg()), _tiny(jax_get_cfg())
    for c in (cfg, jcfg):
        c.TPU.DEVICE_PREPROCESS = True
        c.TPU.RAW_BUCKETS = ((384, 512), (512, 384))
    ours = build_detection_train_loader(cfg, names, seed=11)
    ref = jax_train_loader(jcfg, tuple(PREFIX + n for n in names), seed=11)
    try:
        for _ in range(3):
            a, b = next(ours), next(ref)
            draws = ("short", "flip")
            _assert_batches_equal(
                (a[0], a[1], {k: v for k, v in a[2].items()
                              if k not in draws}), b)
            for key in draws:
                np.testing.assert_array_equal(a[2][key], b[2][key])
            assert a[2]["target_hw"] == b[2]["target_hw"]
            assert a[2]["max_size"] == b[2]["max_size"] == 320
            resized = preprocess_batch(a[0], a[2])
            assert tuple(resized.image.shape[1:3]) == a[2]["target_hw"]
            assert resized.image.dtype == torch.float32
    finally:
        ours.close()
        if hasattr(ref, "close"):
            ref.close()


def test_device_batches_on_the_cpu_keep_order_and_stop_their_thread(voc):
    cfg = _tiny(get_cfg())
    loader = list(build_detection_test_loader(cfg, "voc_2007_test_all1",
                                              batch_size=3))
    before = threading.active_count()
    fed = device_batches(iter(loader), "cpu")
    got = list(fed)
    assert len(got) == len(loader)
    for (a, _, ma), (b, _, mb) in zip(got, loader):
        assert torch.equal(a.image, b.image) and ma == mb
    fed.close()
    assert threading.active_count() <= before


def test_prefetcher_hands_an_error_to_the_consumer_and_closes():
    def broken():
        yield 1
        raise OSError("disk gone")

    p = Prefetcher(broken)
    assert next(p) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(p)

    def endless():
        k = 0
        while True:
            yield k
            k += 1

    p = Prefetcher(endless, maxsize=2)
    assert [next(p) for _ in range(3)] == [0, 1, 2]
    p.close(timeout=10)
    assert not p._t.is_alive()
