"""Complete default config schema.

Covers (a) the detectron2 keys the reference model actually consumes, (b) the
DeFRCN additions (defrcn/config/defaults.py:1-35), (c) the experiment keys
added at runtime by the reference's main.py:36-44 (MODEL.ADDITION.*), and
(d) the keys the reference reads but never defines — set only via run-script
--opts (SURVEY.md §1 "known broken paths"): MODEL.ROI_HEADS.{TEACHER_TRAINING,
STUDENT_TRAINING, DISTILLATE, L2, L2_COSINE, KL, KL_TEMP},
MODEL.DISTILLATION.TEACHER_TRAINING, MODEL.ADDITION.SEMANTIC_DIM,
MODEL.RPN.ADDITION.

TPU-specific keys live under ``TPU.*`` (static padded shapes, mesh, dtype).
The PyTorch port keeps every key name, so ``configs/`` loads unchanged; it
reads the shape and dtype keys under ``TPU.*`` with the same meaning.
"""

from .config import CfgNode

_C = CfgNode()
_C.VERSION = 2
_C.OUTPUT_DIR = "./output"
_C.SEED = -1
_C.CUDNN_BENCHMARK = False
_C.MUTE_HEADER = True
# Output dir for the teacher-novel fine-tune stage. Another key the
# reference passes via --opts without ever committing a schema entry
# (run_text_train_teacher_novel.sh:44 `TEACHER_NOVEL_DIR ${...}`).
_C.TEACHER_NOVEL_DIR = ""

# ---------------------------------------------------------------- MODEL --
_C.MODEL = CfgNode()
# the port runs on the card unless the caller asks for "cpu"
_C.MODEL.DEVICE = "cuda"
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.WEIGHTS = ""
_C.MODEL.MASK_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.LOAD_PROPOSALS = False
# Caffe2 ImageNet pretrained stats (BGR order).
_C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
_C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

_C.MODEL.BACKBONE = CfgNode()
_C.MODEL.BACKBONE.NAME = "build_resnet_backbone"
_C.MODEL.BACKBONE.FREEZE = False
_C.MODEL.BACKBONE.FREEZE_AT = 3
_C.MODEL.BACKBONE.SIZE_DIVISIBILITY = 32

_C.MODEL.RESNETS = CfgNode()
_C.MODEL.RESNETS.DEPTH = 101
_C.MODEL.RESNETS.OUT_FEATURES = ("res4",)
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.NORM = "FrozenBN"
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = (False, False, False, False)

_C.MODEL.ANCHOR_GENERATOR = CfgNode()
_C.MODEL.ANCHOR_GENERATOR.SIZES = ((32, 64, 128, 256, 512),)
_C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = ((0.5, 1.0, 2.0),)
_C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

_C.MODEL.PROPOSAL_GENERATOR = CfgNode()
_C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
_C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

_C.MODEL.RPN = CfgNode()
_C.MODEL.RPN.IN_FEATURES = ("res4",)
_C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
_C.MODEL.RPN.IOU_THRESHOLDS = (0.3, 0.7)
_C.MODEL.RPN.IOU_LABELS = (0, -1, 1)
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
_C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
_C.MODEL.RPN.LOSS_WEIGHT = 1.0
_C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
_C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7
_C.MODEL.RPN.BOUNDARY_THRESH = -1
# DeFRCN additions (ref defrcn/config/defaults.py:10-13)
_C.MODEL.RPN.FREEZE = False
_C.MODEL.RPN.ENABLE_DECOUPLE = False
_C.MODEL.RPN.BACKWARD_SCALE = 1.0
# Used by GeneralizedTextRCNN (ref rcnn.py:363), never defined upstream.
_C.MODEL.RPN.ADDITION = False

_C.MODEL.ROI_HEADS = CfgNode()
_C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
_C.MODEL.ROI_HEADS.NUM_CLASSES = 80
_C.MODEL.ROI_HEADS.IN_FEATURES = ("res4",)
_C.MODEL.ROI_HEADS.IOU_THRESHOLDS = (0.5,)
_C.MODEL.ROI_HEADS.IOU_LABELS = (0, 1)
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
_C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
_C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True
# DeFRCN additions (ref defrcn/config/defaults.py:16-22)
_C.MODEL.ROI_HEADS.FREEZE_FEAT = False
_C.MODEL.ROI_HEADS.ENABLE_DECOUPLE = False
_C.MODEL.ROI_HEADS.BACKWARD_SCALE = 1.0
_C.MODEL.ROI_HEADS.OUTPUT_LAYER = "FastRCNNOutputLayers"
_C.MODEL.ROI_HEADS.CLS_DROPOUT = False
_C.MODEL.ROI_HEADS.DROPOUT_RATIO = 0.8
# Teacher/student distillation keys — read by TextRes5ROIHeads
# (ref roi_heads.py:608-765) but absent from the committed schema.
_C.MODEL.ROI_HEADS.TEACHER_TRAINING = False
_C.MODEL.ROI_HEADS.STUDENT_TRAINING = False
_C.MODEL.ROI_HEADS.DISTILLATE = False
_C.MODEL.ROI_HEADS.L2 = False
_C.MODEL.ROI_HEADS.L2_COSINE = False
# KL defaults True: the reference's active student recipe
# (run_text_train_teacher_novel.sh:61) sets DISTILLATE without KL yet its
# forward_student computes loss_kl unconditionally under training
# (ref roi_heads.py:746-765, the KL guard line itself commented out) —
# so the authors' uncommitted defaults must have enabled it. The knob IS
# honored here (distill_kl = DISTILLATE and KL, the commented guard's
# intent) so KL False genuinely disables the logit distill.
_C.MODEL.ROI_HEADS.KL = True
_C.MODEL.ROI_HEADS.KL_TEMP = 1.0

_C.MODEL.ROI_BOX_HEAD = CfgNode()
_C.MODEL.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
_C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
_C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
_C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
_C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NORM = ""

# Text/semantic branch (ref main.py:36-44 add_new_configs).
_C.MODEL.ADDITION = CfgNode()
_C.MODEL.ADDITION.NAME = "none"  # none | glove | clip
_C.MODEL.ADDITION.TEACHER_TRAINING = False
_C.MODEL.ADDITION.STUDENT_TRAINING = False
_C.MODEL.ADDITION.DISTIL_MODE = "none"
_C.MODEL.ADDITION.FREEZEATTENTION = False
_C.MODEL.ADDITION.SEMANTIC_DIM = 300
_C.MODEL.ADDITION.EMBEDDING_PATH = "datasets"

# Ref rcnn.py:364 reads MODEL.DISTILLATION.TEACHER_TRAINING (undefined there).
_C.MODEL.DISTILLATION = CfgNode()
_C.MODEL.DISTILLATION.TEACHER_TRAINING = False

# -------------------------------------------------------------- DATASETS --
_C.DATASETS = CfgNode()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()

_C.DATALOADER = CfgNode()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.ASPECT_RATIO_GROUPING = True
_C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
# LVIS-style repeat-factor oversampling threshold (d2 default 0.0); only
# read when SAMPLER_TRAIN == "RepeatFactorTrainingSampler"
_C.DATALOADER.REPEAT_THRESHOLD = 0.0
_C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True
_C.DATALOADER.NATIVE_IO = True  # C++ jpeg decode/resize core (csrc/)

# ---------------------------------------------------------------- SOLVER --
_C.SOLVER = CfgNode()
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.BASE_LR = 0.02
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.NESTEROV = False
_C.SOLVER.WEIGHT_DECAY = 5e-5
_C.SOLVER.WEIGHT_DECAY_NORM = 0.0
_C.SOLVER.WEIGHT_DECAY_BIAS = 5e-5
_C.SOLVER.BIAS_LR_FACTOR = 1.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (60000, 80000)
_C.SOLVER.MAX_ITER = 90000
_C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
_C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
_C.SOLVER.WARMUP_ITERS = 1000
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.CLIP_GRADIENTS = CfgNode()
_C.SOLVER.CLIP_GRADIENTS.ENABLED = False
_C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
_C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
_C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0

# ----------------------------------------------------------------- INPUT --
_C.INPUT = CfgNode()
_C.INPUT.MIN_SIZE_TRAIN = (640, 672, 704, 736, 768, 800)
_C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.RANDOM_FLIP = "horizontal"
_C.INPUT.FORMAT = "BGR"
# d2 random-crop aug (reference dataset_mapper.py:82-83). Parses for
# d2-config compatibility; ENABLED=True fails loudly at build (no
# reference config crops — models/build.py _FIXED_AT_DEFAULT)
_C.INPUT.CROP = CfgNode()
_C.INPUT.CROP.ENABLED = False
_C.INPUT.CROP.TYPE = "relative_range"
_C.INPUT.CROP.SIZE = (0.9, 0.9)

# ------------------------------------------------------------------ TEST --
_C.TEST = CfgNode()
_C.TEST.EXPECTED_RESULTS = ()
_C.TEST.EVAL_PERIOD = 0
_C.TEST.DETECTIONS_PER_IMAGE = 100
_C.TEST.AUG = CfgNode()
_C.TEST.AUG.ENABLED = False
# d2-surface compatibility key (ref defaults.py:312-320 registers the hook
# gated on it); structurally a no-op here AND in the reference: every BN
# is FrozenBN, so d2's get_bn_modules() finds nothing and the hook never
# activates. Kept so configs carrying the key parse.
_C.TEST.PRECISE_BN = CfgNode()
_C.TEST.PRECISE_BN.ENABLED = False
_C.TEST.PRECISE_BN.NUM_ITER = 200
# Evaluate WITHOUT feeding test-time GT to painting meta-archs: forces the
# Semantic/Text families onto their all-background serving fallback
# (PARITY #12a) instead of the reference's GT-painted protocol — the
# NON-LEAKY evaluation of the deployable path. No reference equivalent
# (the reference can only evaluate GT-painted, rcnn.py:64-67). Used by the
# generalization gate's text-serving leg.
_C.TEST.NO_GT_EVAL = False
# PCB (ref defrcn/config/defaults.py:25-31)
_C.TEST.PCB_ENABLE = False
_C.TEST.PCB_MODELTYPE = "resnet"
_C.TEST.PCB_MODELPATH = ""
_C.TEST.PCB_ALPHA = 0.50
_C.TEST.PCB_UPPER = 1.0
_C.TEST.PCB_LOWER = 0.05

# ------------------------------------------------------------------- TPU --
# TPU-native static-shape and parallelism knobs (no reference equivalent —
# the reference relies on dynamic shapes + DDP).
_C.TPU = CfgNode()
_C.TPU.MAX_GT = 100                 # padded GT instances per image
_C.TPU.IMAGE_BUCKETS = ((512, 864), (672, 1120), (800, 1344))  # (h, w) pads
# candidate cap for the final class-aware NMS; the reference has no cap
# (it NMSes every (proposal, class) pair above 0.05) — 2048 keeps COCO-80
# clipping negligible at ~1.5 ms extra
_C.TPU.MAX_DETECTIONS_PRE_NMS = 2048
_C.TPU.COMPUTE_DTYPE = "bfloat16"   # backbone/head matmul dtype
# off by default: batch-16 bf16 training fits HBM without remat
_C.TPU.REMAT_BACKBONE = False
# observability (SURVEY.md §5.1/§5.2): profiler trace capture + NaN guard
_C.TPU.PROFILE_START_STEP = -1   # step to start a jax.profiler trace (-1 off)
_C.TPU.PROFILE_NUM_STEPS = 5
_C.TPU.DEBUG_NANS = False        # jax debug_nans mode (slow; debugging only)
_C.TPU.CHECKPOINT_BACKEND = "pickle"  # pickle | orbax
# overlap checkpoint serialization+fsync with training (device_get stays
# synchronous; writes remain ordered + crash-safe; train() drains at exit)
_C.TPU.ASYNC_CHECKPOINT = True
# ROIs per unrolled ROIAlign->res5 chunk (0 = no chunking; ~5% faster at
# inference but raises peak HBM — measured safe at batch 8 bf16)
_C.TPU.ROI_CHUNK = 256
# Pool only the even bins of the 7x7 ROIAlign grid (the only ones res5's
# stride-2-in-1x1 block0 ever reads) and run res5 at stride 1 instead.
# Numerically identical (tests/test_pool_elision.py); ~43% less HBM traffic
# on the pooled path. Auto-disabled when MODEL.RESNETS.STRIDE_IN_1X1=False.
_C.TPU.ELIDE_STRIDED_BINS = True
# Host-side 2x2 space-to-depth: the loader ships (H/2, W/2, 12) uint8 and
# the stem consumes it directly. Skips the on-device C=3 relayout
# (~1.6 ms/step at batch 8) that the space-to-depth stem otherwise pays.
# Ignored in DEVICE_PREPROCESS mode (raw pixels are resized on device).
_C.TPU.HOST_SPACE_TO_DEPTH = True
# Fused device-side preprocessing: loader ships RAW pixels (padded to a
# RAW_BUCKETS source bucket); resize/flip run on the TPU inside the train
# step (data/xla_preprocess.py).
_C.TPU.DEVICE_PREPROCESS = False
_C.TPU.RAW_BUCKETS = ((384, 512), (512, 512), (512, 768), (768, 1024))
# Spatial partitioning for low-latency serving (DefaultPredictor only):
# split the image's H axis over S devices so the backbone of ONE
# image runs in row bands (halo rows exchanged before every layer that
# reads neighbouring rows, parallel/spatial.py); res4 gathers back before
# the RPN/ROI stages. Cuts batch-1 latency when a single
# image underfills the chip. 1 = off. The reference has no latency-
# scaling story (DDP only helps throughput).
_C.TPU.SPATIAL_PARTITION = 1
# ZeRO-style parameter/optimizer sharding over a second mesh axis: the
# mesh becomes (data = ndev/M, model = M); large tensors are stored
# 1/M-sharded (GSPMD all-gathers at use, reduce-scatters the grads),
# cutting per-chip param+optimizer HBM by ~M. The reference is DP-only
# (SURVEY.md §2.3); this is optional TPU headroom for chips too small to
# replicate the model. 1 = pure DP (reference parity).
_C.TPU.MODEL_PARALLEL = 1
