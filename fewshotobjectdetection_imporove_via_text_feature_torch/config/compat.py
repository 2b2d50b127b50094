"""Config version compatibility: the detectron2 V0/V1 <-> V2 converter.

Counterpart of the JAX package's ``config/compat.py`` (ref
defrcn/config/compat.py, detectron2's converter stack): per-version
converter classes with in-place ``upgrade`` / ``downgrade``, the
ConverterV1/ConverterV2 rename tables, ``guess_version`` for VERSION-less
partial YAMLs, and the removed keys and legacy aliases pruned at any
VERSION. ``CfgNode.merge_from_file`` drives the fvcore loading flow:
downgrade the full default config to the file's version, merge the partial
file there, then upgrade the merged whole back to the latest version.

Operates on plain nested dicts. Renames whose source key is absent are
skipped, so a partial dict upgrades too.

Rename targets under ``MODEL.RETINANET`` / ``MODEL.PANOPTIC_FPN`` /
``MODEL.SEM_SEG_HEAD`` have no node in this schema (detectron2
architectures the reference never builds): a V1 config that configures a
RetinaNet still fails the strict merge after its upgrade.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

__all__ = [
    "LATEST_VERSION",
    "downgrade_config",
    "guess_version",
    "prune_removed_keys",
    "upgrade_config",
]

LATEST_VERSION = 2

# Keys that earlier revisions of this schema had and that were removed.
# A config.yaml dumped into an older run's OUTPUT_DIR carries them (at any
# VERSION), so they are pruned, not renamed, before the strict merge.
_DELETED = (
    "TPU.MESH_DATA_AXIS",  # the mesh axis became an API parameter
)

# Legacy spellings (maskrcnn-benchmark era) outside detectron2's versioned
# tables, canonicalized at any VERSION: the target name exists in every
# version, so a converter rename would break files that already use it.
_LEGACY_ALIASES = (
    ("MODEL.RPN.RPN_STRADDLE_THRESH", "MODEL.RPN.BOUNDARY_THRESH"),
)


def prune_removed_keys(cfg_dict: dict) -> dict:
    """Drop the keys this schema removed and canonicalize the legacy
    aliases (any VERSION)."""
    for dead in _DELETED:
        if _pop(cfg_dict, dead):
            logger.info("Dropping removed config key %s", dead)
    for old, new in _LEGACY_ALIASES:
        _rename(cfg_dict, old, new)
    return cfg_dict


def guess_version(cfg_dict: dict, filename: str = "<dict>") -> int:
    """detectron2's guess: a partial config without VERSION is v1 when it
    carries a v1-only key, else the latest."""
    def _has(name: str) -> bool:
        cur = cfg_dict
        for n in name.split("."):
            if not isinstance(cur, dict) or n not in cur:
                return False
            cur = cur[n]
        return True

    if _has("MODEL.WEIGHT") or _has("TEST.AUG_ON"):
        logger.warning(
            "Config '%s' has no VERSION. Assuming it to be v1.", filename
        )
        return 1
    logger.warning(
        "Config '%s' has no VERSION. Assuming it to be compatible with "
        "latest v%d.", filename, LATEST_VERSION,
    )
    return LATEST_VERSION


def upgrade_config(cfg_dict: dict, to_version: int = LATEST_VERSION) -> dict:
    """Upgrade a config dict from its VERSION (the latest when absent) to
    ``to_version`` in place, and return it."""
    prune_removed_keys(cfg_dict)
    version = cfg_dict.get("VERSION", LATEST_VERSION)
    if version > to_version:
        raise ValueError(
            f"Cannot upgrade from v{version} to v{to_version}"
        )
    for k in range(version, to_version):
        _CONVERTERS[k + 1].upgrade(cfg_dict)
        cfg_dict["VERSION"] = k + 1
    return cfg_dict


def downgrade_config(cfg_dict: dict, to_version: int) -> dict:
    """Downgrade a config dict to an older version in place, and return it.
    As in detectron2, only good enough to recover the old version's
    defaults, so that an old partial YAML merges into them."""
    version = cfg_dict.get("VERSION", LATEST_VERSION)
    if version < to_version:
        raise ValueError(
            f"Cannot downgrade from v{version} to v{to_version}"
        )
    for k in range(version, to_version, -1):
        _CONVERTERS[k].downgrade(cfg_dict)
        cfg_dict["VERSION"] = k - 1
    return cfg_dict


# dotted-path helpers (detectron2's compat._rename: the old key deleted and
# its emptied parents pruned, the new path created)


def _get(d: dict, dotted: str, default=None):
    cur = d
    for p in dotted.split("."):
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def _set(d: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _pop(d: dict, dotted: str) -> bool:
    parts = dotted.split(".")
    chain = [d]
    for p in parts[:-1]:
        nxt = chain[-1].get(p)
        if not isinstance(nxt, dict):
            return False
        chain.append(nxt)
    if parts[-1] not in chain[-1]:
        return False
    chain[-1].pop(parts[-1])
    for i in range(len(chain) - 1, 0, -1):  # prune now-empty parents
        if not chain[i]:
            del chain[i - 1][parts[i - 1]]
    return True


def _rename(d: dict, old: str, new: str) -> None:
    parts = old.split(".")
    cur = d
    for p in parts[:-1]:
        if not isinstance(cur, dict) or p not in cur:
            return
        cur = cur[p]
    if parts[-1] not in cur:
        return
    value = cur[parts[-1]]
    _pop(d, old)
    _set(d, new, value)


# the converters (ref compat.py ConverterV1 / ConverterV2)


class _RenameConverter:
    RENAME: list = []  # (old name, new name)

    @classmethod
    def upgrade(cls, cfg: dict) -> None:
        for old, new in cls.RENAME:
            _rename(cfg, old, new)

    @classmethod
    def downgrade(cls, cfg: dict) -> None:
        for old, new in cls.RENAME[::-1]:
            _rename(cfg, new, old)


class ConverterV1(_RenameConverter):
    RENAME = [("MODEL.RPN_HEAD.NAME", "MODEL.RPN.HEAD_NAME")]


class ConverterV2(_RenameConverter):
    """The bulk rename before detectron2's public release (ref
    compat.py:166-264)."""

    RENAME = [
        ("MODEL.WEIGHT", "MODEL.WEIGHTS"),
        ("MODEL.PANOPTIC_FPN.SEMANTIC_LOSS_SCALE",
         "MODEL.SEM_SEG_HEAD.LOSS_WEIGHT"),
        ("MODEL.PANOPTIC_FPN.RPN_LOSS_SCALE", "MODEL.RPN.LOSS_WEIGHT"),
        ("MODEL.PANOPTIC_FPN.INSTANCE_LOSS_SCALE",
         "MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT"),
        ("MODEL.PANOPTIC_FPN.COMBINE_ON",
         "MODEL.PANOPTIC_FPN.COMBINE.ENABLED"),
        ("MODEL.PANOPTIC_FPN.COMBINE_OVERLAP_THRESHOLD",
         "MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH"),
        ("MODEL.PANOPTIC_FPN.COMBINE_STUFF_AREA_LIMIT",
         "MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT"),
        ("MODEL.PANOPTIC_FPN.COMBINE_INSTANCES_CONFIDENCE_THRESHOLD",
         "MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH"),
        ("MODEL.ROI_HEADS.SCORE_THRESH", "MODEL.ROI_HEADS.SCORE_THRESH_TEST"),
        ("MODEL.ROI_HEADS.NMS", "MODEL.ROI_HEADS.NMS_THRESH_TEST"),
        ("MODEL.RETINANET.INFERENCE_SCORE_THRESHOLD",
         "MODEL.RETINANET.SCORE_THRESH_TEST"),
        ("MODEL.RETINANET.INFERENCE_TOPK_CANDIDATES",
         "MODEL.RETINANET.TOPK_CANDIDATES_TEST"),
        ("MODEL.RETINANET.INFERENCE_NMS_THRESHOLD",
         "MODEL.RETINANET.NMS_THRESH_TEST"),
        ("TEST.DETECTIONS_PER_IMG", "TEST.DETECTIONS_PER_IMAGE"),
        ("TEST.AUG_ON", "TEST.AUG.ENABLED"),
        ("TEST.AUG_MIN_SIZES", "TEST.AUG.MIN_SIZES"),
        ("TEST.AUG_MAX_SIZE", "TEST.AUG.MAX_SIZE"),
        ("TEST.AUG_FLIP", "TEST.AUG.FLIP"),
    ]

    @classmethod
    def upgrade(cls, cfg: dict) -> None:
        super().upgrade(cfg)

        if _get(cfg, "MODEL.META_ARCHITECTURE") == "RetinaNet":
            _rename(cfg, "MODEL.RETINANET.ANCHOR_ASPECT_RATIOS",
                    "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS")
            _rename(cfg, "MODEL.RETINANET.ANCHOR_SIZES",
                    "MODEL.ANCHOR_GENERATOR.SIZES")
            _pop(cfg, "MODEL.RPN.ANCHOR_SIZES")
            _pop(cfg, "MODEL.RPN.ANCHOR_ASPECT_RATIOS")
        else:
            _rename(cfg, "MODEL.RPN.ANCHOR_ASPECT_RATIOS",
                    "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS")
            _rename(cfg, "MODEL.RPN.ANCHOR_SIZES",
                    "MODEL.ANCHOR_GENERATOR.SIZES")
            _pop(cfg, "MODEL.RETINANET.ANCHOR_SIZES")
            _pop(cfg, "MODEL.RETINANET.ANCHOR_ASPECT_RATIOS")
        _pop(cfg, "MODEL.RETINANET.ANCHOR_STRIDES")

    @classmethod
    def downgrade(cls, cfg: dict) -> None:
        super().downgrade(cfg)

        _rename(cfg, "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS",
                "MODEL.RPN.ANCHOR_ASPECT_RATIOS")
        _rename(cfg, "MODEL.ANCHOR_GENERATOR.SIZES",
                "MODEL.RPN.ANCHOR_SIZES")
        # detectron2 mirrors the anchors into the RetinaNet node so that a
        # v1 RetinaNet YAML still merges; ANCHOR_STRIDES "is not used
        # anywhere in any version" (ref compat.py:262)
        ar = _get(cfg, "MODEL.RPN.ANCHOR_ASPECT_RATIOS")
        if ar is not None:
            _set(cfg, "MODEL.RETINANET.ANCHOR_ASPECT_RATIOS", ar)
        sz = _get(cfg, "MODEL.RPN.ANCHOR_SIZES")
        if sz is not None:
            _set(cfg, "MODEL.RETINANET.ANCHOR_SIZES", sz)
        _set(cfg, "MODEL.RETINANET.ANCHOR_STRIDES", [])


_CONVERTERS = {1: ConverterV1, 2: ConverterV2}
