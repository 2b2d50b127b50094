"""A plumbing run of the port's run_text_train_teacher.sh then
run_visualize.sh, unmodified, on the CPU at the tiny size from a scratch
working directory (the class embeddings generated first, the similarity
figure last); split from tests/test_torch_entry_points.py so that each
file is a small share of one xdist worker. CLI children run with one
intra-op thread."""

import json
import os
import subprocess
import sys

from tests.test_torch_entry_points import (  # noqa: F401
    PORT,
    ROOT,
    TOOLS,
)

TINY_YAML = """_BASE_: "{base}"
MODEL:
  RESNETS: {{DEPTH: 14, STEM_OUT_CHANNELS: 8, RES2_OUT_CHANNELS: 16,
            WIDTH_PER_GROUP: 4}}
  BACKBONE: {{FREEZE_AT: 0}}
  RPN: {{PRE_NMS_TOPK_TRAIN: 128, POST_NMS_TOPK_TRAIN: 32,
        PRE_NMS_TOPK_TEST: 128, POST_NMS_TOPK_TEST: 32}}
  ROI_HEADS: {{BATCH_SIZE_PER_IMAGE: 16, SCORE_THRESH_TEST: 0.0}}
TPU: {{IMAGE_BUCKETS: "((128,192),)", MAX_GT: 10,
      MAX_DETECTIONS_PRE_NMS: 64, COMPUTE_DTYPE: float32}}
INPUT: {{MIN_SIZE_TRAIN: "(128,)", MAX_SIZE_TRAIN: 192, MIN_SIZE_TEST: 128,
        MAX_SIZE_TEST: 192}}
SOLVER: {{IMS_PER_BATCH: 2, BASE_LR: 0.001, WARMUP_ITERS: 0, MAX_ITER: 2,
         STEPS: "(1,)", CHECKPOINT_PERIOD: 0}}
SEED: 5
"""


def test_text_teacher_then_visualize_plumbing_on_the_cpu(tmp_path):
    """The two scripts unmodified, DEVICE=cpu, from a scratch working
    directory whose configs/voc/defrcn_det_r101_base1.yaml is the shipped
    one at the tiny size and a 2-step schedule; the class embeddings
    generated first, as the README asks; the similarity figure last."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
        make_voc,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_weights import (
        write_c2_pkl,
    )

    wd = tmp_path / "wd"
    (wd / "configs" / "voc").mkdir(parents=True)
    (wd / "configs" / "voc" / "defrcn_det_r101_base1.yaml").write_text(
        TINY_YAML.format(
            base=ROOT / "configs" / "voc" / "defrcn_det_r101_base1.yaml"))
    (wd / "tools").mkdir()
    for tool in ("create_config.py", "extract_results.py"):
        (wd / "tools" / tool).symlink_to(ROOT / "tools" / tool)
    make_voc(str(wd / "datasets"), images=3)
    write_c2_pkl(str(tmp_path / "R-14.pkl"), seed=0, depth=14,
                 stem_out=8, res2_out=16, bottleneck=4)
    env = dict(os.environ, DEVICE="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               IMAGENET_PRETRAIN=str(tmp_path / "R-14.pkl"),
               PCB_PRETRAIN=str(tmp_path / "no-pcb.pth"))
    env.pop("FSODTF_DATASETS", None)
    env.pop("PYTHONPATH", None)

    def run(*cmd, **extra):
        r = subprocess.run(list(cmd), cwd=str(wd), env=dict(env, **extra),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, (cmd, r.stdout[-3000:], r.stderr[-3000:])
        return r

    run(sys.executable, "-m", f"{PORT}.tools.generate_class_embeddings",
        PYTHONPATH=str(ROOT))
    assert len(list((wd / "datasets" / "glove").iterdir())) == 87
    run("bash", str(TOOLS / "run_text_train_teacher.sh"))
    teacher = wd / "outputs/singleHeadAtt_Text/teacher_base/defrcn_det_r101_base1"
    assert (teacher / "model_final.pth").is_file()
    assert (teacher / "model_reset_surgery.pth").is_file()
    run("bash", str(TOOLS / "run_visualize.sh"))
    dets = json.loads((teacher / "coco_instances_results.json").read_text())
    assert dets
    drawn = sorted((teacher / "visualizations").iterdir())
    assert len(drawn) == len({d["image_id"] for d in dets}) == 3
    run(sys.executable, "-m", f"{PORT}.tools.visualize_confusion_matrix",
        "--output", str(teacher / "similarity.png"), PYTHONPATH=str(ROOT))
    assert (teacher / "similarity.png").is_file() or \
        (teacher / "similarity.csv").is_file()
