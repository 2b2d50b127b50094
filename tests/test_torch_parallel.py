"""The port's multi-device layer against the JAX package, on the CPU: gloo
ranks spawned by ``engine/launch.py``, float32, the tiny detectors of
tests/test_torch_train_model.py and tests/test_torch_text_heads.py.

One spawn of two ranks (``dryrun_multidevice.tasks_worker``, through a file
store under tmp_path, killed after 120 s) runs every two-rank case; the
JAX package's global-batch step is computed here and compared with what
the ranks return:

  * a DDP step of the flagship and of the text student (the teacher's keys
    span both ranks) against the JAX package's ``jax.value_and_grad`` of
    the loss on the global batch, with exhaustive sampling budgets so the
    two packages' draws choose the same sets: losses at rtol 1e-4,
    gradients within 1e-3 of their largest values, on a batch whose two
    images sample different numbers of valid ROIs;
  * TPU.MODEL_PARALLEL 2 (FSDP2, mesh (1, 2)) against the DP step of the
    same ranks (two steps, gradients clipped by norm), with parameters and
    momentum sharded, its
    checkpoint and DP's loading at world 1, and a world-1 checkpoint
    resumed at world 2;
  * evaluation sharded over the ranks against one process.

Without spawning: the ZeRO partition rule against the JAX package's, and
the sharded test loader against the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.meta_voc import (
    register_meta_voc as jax_register_meta_voc,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.parallel.mesh import (
    ZERO_MIN_SIZE as JAX_ZERO_MIN_SIZE,
    param_partition_spec as jax_partition_spec,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    load_training_state,
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    build_detection_test_loader,
    register_all,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.mapper import (
    DatasetMapper,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.parallel import (
    ZERO_MIN_SIZE,
    param_partition_spec,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    dryrun_multidevice as dr,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
    make_voc,
)
from tests.test_torch_model import inputs, jax_images
from tests.test_torch_text_heads import jax_model as text_jax_model
from tests.test_torch_text_heads import text_kwargs
from tests.test_torch_train_model import (
    gt_arrays,
    jax_grads_by_name,
    jax_params,
    total_loss,
    train_kwargs,
)

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # of each gradient's largest value
TIMEOUT = 120.0  # seconds the spawned ranks may run
PREFIX = "torchparallel_"


@pytest.mark.parametrize("shape,model,min_size", [
    ((3, 3, 512, 512), 2, 1),   # ties go to the last dimension
    ((2048, 21), 2, 1),
    ((21, 2048), 2, 1),         # the largest divisible dimension
    ((21, 5), 2, 1),            # nothing divisible: whole
    ((512,), 2, None),          # under ZERO_MIN_SIZE: whole
    ((3, 3, 512, 512), 1, 1),   # no model axis: whole
])
def test_partition_rule_is_the_jax_packages(shape, model, min_size):
    kw = {} if min_size is None else {"min_size": min_size}
    assert ZERO_MIN_SIZE == JAX_ZERO_MIN_SIZE
    assert param_partition_spec(shape, model, **kw) == tuple(
        jax_partition_spec(shape, model, **kw))


def _numpy_batch():
    """tests/test_torch_train_model.py's padded two-image batch, with two of
    the second image's four GT boxes dropped: the images then sample 304
    and 302 valid ROIs (every proposal and every GT box)."""
    canvas, hw, orig = inputs(True)
    boxes, classes, valid = gt_arrays(hw)
    valid[1, 2:] = False
    return dict(canvas=canvas, hw=hw, orig=orig, boxes=boxes,
                classes=classes, valid=valid)


def _jax_step(jmodel, params, batch):
    """The JAX package's losses and gradients on the global batch."""
    images = jax_images(batch["canvas"], batch["hw"], batch["orig"])
    gt = JaxGT(jnp.asarray(batch["boxes"]), jnp.asarray(batch["classes"]),
               jnp.asarray(batch["valid"]))

    def loss_fn(p):
        losses = jmodel.apply(
            {"params": p}, images, gt, train=True,
            rngs={"sampling": jax.random.PRNGKey(1),
                  "dropout": jax.random.PRNGKey(2)})
        return total_loss(losses), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return ({k: float(v) for k, v in jax.device_get(losses).items()},
            jax_grads_by_name(grads))


def _state(params):
    return {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every two-rank case in one spawn, and the references."""
    work = str(tmp_path_factory.mktemp("parallel"))
    batch = _numpy_batch()
    jmodel, params = jax_params()
    flag = dict(kwargs=train_kwargs(), state=_state(params), batch=batch,
                steps=1)
    flag_ref = _jax_step(jmodel, params, batch)
    head = "TextRes5ROIHeads"
    tjmodel, tparams = text_jax_model(head=head)
    text = dict(flag, kwargs=text_kwargs(head=head), state=_state(tparams))
    text_ref = _jax_step(tjmodel, tparams, batch)

    # ZeRO against DP, two steps on dryrun_multidevice's sampled detector,
    # each gradient clipped to norm 0.05 (the norm of the whole tensor)
    small = dict(kwargs=dict(dr.TINY, **dr.SAMPLED), state=None,
                 batch=dr.tiny_batch(2), steps=2, clip=("norm", 0.05))
    ckpt = {k: os.path.join(work, f"{k}.pth") for k in ("dp", "zero", "one")}
    dp = dict(small, checkpoint=ckpt["dp"])
    zero = dict(small, model_parallel=2, checkpoint=ckpt["zero"])
    # a world-1 checkpoint after step 0, resumed at world 2 for step 1
    dr.step_worker(dict(small, steps=1, checkpoint=ckpt["one"]))
    one = dr.step_worker(small)
    resume = dict(small, model_parallel=2, resume=ckpt["one"], first_step=1,
                  steps=1)

    datasets = os.path.join(work, "voc")
    make_voc(datasets, images=6)
    ev = dict(datasets=datasets, batch_size=2,
              out_dir=os.path.join(work, "eval"))
    tasks = [("step", flag), ("step", text), ("step", dp), ("step", zero),
             ("step", resume), ("eval", ev)]
    got = dr.run_ranks(tasks, 2, work, timeout=TIMEOUT)
    ev_ref = dr.eval_worker(ev)
    return dict(got=dict(zip(("flag", "text", "dp", "zero", "resume", "eval"),
                             got)),
                ref=dict(flag=flag_ref, text=text_ref, one=one, eval=ev_ref),
                ckpt=ckpt, small=small)


def _against_jax(got, ref):
    losses, grads = ref
    for g in got:
        assert set(g["losses"][0]) == set(losses) | {"total_loss"}
        for k, want in losses.items():
            np.testing.assert_allclose(g["losses"][0][k], want,
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        assert set(g["grads"]) <= set(grads)
        for name, have in g["grads"].items():
            want = grads[name]
            np.testing.assert_allclose(
                have, want, rtol=0, atol=GRAD_TOL * float(np.abs(want).max()),
                err_msg=name)
    counts = [g["roi_valid"] for g in got]
    assert counts[0] != counts[1], counts  # the normalizers are exercised


def test_ddp_step_is_the_jax_packages_global_batch_step(ranks):
    got = ranks["got"]["flag"]
    _against_jax(got, ranks["ref"]["flag"])
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["losses"][0]["loss_box_reg"] > 0


def test_text_student_step_attends_over_both_ranks_rois(ranks):
    got = ranks["got"]["text"]
    _against_jax(got, ranks["ref"]["text"])
    for k in ("loss_kl", "loss_student_feat", "loss_cls_t"):
        assert got[0]["losses"][0][k] > 0, k


def test_zero_step_equals_dp_with_parameters_and_momentum_sharded(ranks):
    dp, zero = ranks["got"]["dp"], ranks["got"]["zero"]
    for z in zero:
        dr.compare_steps(z, dp[0], f"rank {z['rank']}")
        assert z["reload_max_diff"] == 0.0
    sizes = zero[0]["sizes"]
    sharded = [n for n, (_, whole, _) in sizes.items()
               if whole >= ZERO_MIN_SIZE]
    assert sharded  # the tiny detector has tensors the rule shards
    for n in sharded:  # half a tensor the rule shards on each rank
        assert sizes[n][0] * 2 == sizes[n][1], (n, sizes[n])
    for n, (local, _, mom) in sizes.items():
        assert mom == local, n  # momentum lives with its shard
    local = sum(v[0] for v in sizes.values())
    whole = sum(v[1] for v in sizes.values())
    assert local < 0.6 * whole, (local, whole)
    for n, (local, whole, _) in dp[0]["sizes"].items():
        assert local == whole, n


def test_zero_step_equals_one_process(ranks):
    dr.compare_steps(ranks["got"]["zero"][0], ranks["ref"]["one"], "ZeRO")


@pytest.mark.parametrize("kind", ["dp", "zero"])
def test_checkpoint_written_at_world_2_loads_at_world_1(ranks, kind):
    got = ranks["got"][kind][0]
    state = torch.load(ranks["ckpt"][kind], weights_only=True)
    model = dr._build(ranks["small"])
    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    load_training_state(model, opt, state)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), got["params"][n],
                                      err_msg=n)
        np.testing.assert_array_equal(
            opt.state[p]["momentum_buffer"].numpy(), got["momentum"][n],
            err_msg=n)


def test_checkpoint_written_at_world_1_resumes_at_world_2(ranks):
    one = ranks["ref"]["one"]
    for r in ranks["got"]["resume"]:
        want = one["losses"][1]
        for k, v in want.items():
            np.testing.assert_allclose(r["losses"][0][k], v,
                                       rtol=dr.LOSS_RTOL, atol=1e-7,
                                       err_msg=k)


def test_sharded_evaluation_equals_one_process_on_every_rank(ranks):
    ref = ranks["ref"]["eval"]
    got = ranks["got"]["eval"]
    for g in got:
        assert g["results"] == ref["results"]
        assert set(g["dets"]) == set(ref["dets"])
        for img, d in ref["dets"].items():
            dr.set_match(g["dets"][img], d)
    assert sum(len(d[0]) for d in ref["dets"].values()) > 20  # teeth
    # 6 images in batches of 2: batches 0 and 2 are rank 0's, 1 rank 1's,
    # and each rank decoded only its own
    decoded = [set(g["decoded"]) for g in got]
    assert [len(d) for d in decoded] == [4, 2]
    assert not decoded[0] & decoded[1]
    assert decoded[0] | decoded[1] == set(ref["decoded"])


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_voc(root, images=7)
    register_all(root)
    name = "voc_2007_test_all1"
    if PREFIX + name not in JaxDatasetCatalog:
        jax_register_meta_voc(PREFIX + name,
                              jax_builtin_metadata("voc_fewshot"),
                              os.path.join(root, "VOC2007"), "test", 2007,
                              "base_novel_1", 1, root=root)
    return root


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_test_loader_is_the_jax_packages(voc, rank):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.INPUT.MIN_SIZE_TEST = 160
        c.INPUT.MAX_SIZE_TEST = 320
        c.TPU.IMAGE_BUCKETS = ((160, 224), (224, 320))
        c.TPU.MAX_GT = 10
    jcfg.TPU.HOST_SPACE_TO_DEPTH = False
    decoded = []
    call = DatasetMapper.__call__

    def recording(self, record, *args, **kwargs):
        decoded.append(record["image_id"])
        return call(self, record, *args, **kwargs)

    DatasetMapper.__call__ = recording
    try:
        ours = list(build_detection_test_loader(
            cfg, "voc_2007_test_all1", batch_size=2, shard=(rank, 2)))
    finally:
        DatasetMapper.__call__ = call
    ref = list(jax_test_loader(jcfg, PREFIX + "voc_2007_test_all1",
                               batch_size=2, shard=(rank, 2)))
    assert len(ours) == len(ref) == 4  # 7 images: 2 + 2 + 2 + 1 (padded)
    owned = set()
    for k, (a, b) in enumerate(zip(ours, ref)):
        if k % 2 != rank:
            assert a == (None, None, {"skip": True, "valid_count": 0})
            assert b[0] is None and b[2]["skip"]
            continue
        images, gt, meta = a
        jimages, jgt, jmeta = b
        np.testing.assert_array_equal(images.image.numpy(),
                                      np.asarray(jimages.image))
        np.testing.assert_array_equal(gt.boxes.numpy(), np.asarray(jgt.boxes))
        assert meta["image_ids"] == jmeta["image_ids"]
        assert meta["valid_count"] == jmeta["valid_count"]
        owned |= set(meta["image_ids"])
    assert set(decoded) == owned and owned


@pytest.mark.parametrize("where", ["trainer", "cli", "export"])
def test_spatial_partition_raises_what_the_jax_package_raises(where):
    """A serving option: training and evaluation refuse it as the JAX
    package does (ValueError, DefaultPredictor serving only), export as not
    exportable; DefaultPredictor runs it (tests/test_torch_spatial_partition.py)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
        export_inference,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.trainer import (
        check_training_config,
    )

    cfg = get_cfg()
    cfg.TPU.SPATIAL_PARTITION = 2
    call, match = {
        "trainer": (lambda: check_training_config(cfg),
                    "DefaultPredictor serving only"),
        "cli": (lambda: cli.check_cli_config(cfg),
                "DefaultPredictor serving only"),
        "export": (lambda: export_inference(cfg, {}, device="cpu"),
                   "not exportable"),
    }[where]
    with pytest.raises(ValueError, match=match):
        call()


def test_spatial_partition_stays_queued_for_the_predictor(monkeypatch):
    """DefaultPredictor takes the option, as the JAX package's does: on the
    CPU its bands all run on the CPU; it refuses a run of more than one
    process with that package's ValueError."""
    import torch.distributed as dist

    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )
    from tests.test_torch_predictor import _tiny

    cfg = _tiny(get_cfg())
    cfg.TPU.SPATIAL_PARTITION = 2
    pred = DefaultPredictor(cfg, device="cpu")
    assert pred.model.spatial_devices == [torch.device("cpu")] * 2
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError,
                       match="TPU.SPATIAL_PARTITION is single-process only"):
        DefaultPredictor(cfg, device="cpu")
