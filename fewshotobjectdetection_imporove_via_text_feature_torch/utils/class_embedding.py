"""Class-name embeddings (GloVe 300-d, CLIP 512-d), counterpart of the JAX
package's ``utils/class_embedding.py`` (ref defrcn/utils/class_embedding.py
:4-24), in numpy.

A class's vector is read from ``{root}/{model}/{class}.txt``. A class with
no file gets a deterministic synthetic unit vector made from its name, the
same numbers as the JAX package's, and the count of such classes is logged:
no GloVe or CLIP file is in the repository. ``create_normalized_orthogonal_
tensor`` is the intended construction of the reference's background vector:
a unit vector orthogonal to the mean foreground embedding.
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

SEMANTIC_DIMS = {"glove": 300, "clip": 512}


def get_class_embed(class_names, model: str,
                    root: str = "datasets") -> np.ndarray:
    """(C, dim) float32 embedding bank of ``class_names``."""
    dim = SEMANTIC_DIMS[model]
    vecs, synthetic = [], []
    for name in class_names:
        path = os.path.join(root, model, f"{name}.txt")
        if os.path.exists(path):
            v = np.loadtxt(path, dtype=np.float64).reshape(-1)
            assert v.shape[0] == dim, f"{path}: dim {v.shape[0]} != {dim}"
        else:
            v = _synthetic_embedding(name, dim)
            synthetic.append(name)
        vecs.append(v)
    if synthetic:
        logger.warning(
            "%d of %d class embeddings are synthetic (no %s file under %s): "
            "%s", len(synthetic), len(vecs), model, root,
            ", ".join(synthetic))
    return np.asarray(vecs, np.float32)


def _synthetic_embedding(name: str, dim: int) -> np.ndarray:
    """A unit vector drawn from ``RandomState`` seeded by the name's bytes
    (little-endian, mod 2**31): a stand-in of a real vector's shape."""
    seed = int.from_bytes(name.encode(), "little") % (2**31)
    v = np.random.RandomState(seed).randn(dim)
    return v / np.linalg.norm(v)


def create_normalized_orthogonal_tensor(vec: np.ndarray):
    """(1, dim) float32 unit vector orthogonal to ``vec``: the fixed
    background embedding of ``SematicProposalAttention`` (ref
    attentive_modules.py:228)."""
    vec = np.asarray(vec, np.float64).reshape(-1)
    r = np.random.RandomState(0).randn(vec.shape[0])
    v_hat = vec / max(np.linalg.norm(vec), 1e-12)
    r = r - np.dot(r, v_hat) * v_hat
    r = r / max(np.linalg.norm(r), 1e-12)
    return r.astype(np.float32).reshape(1, -1)
