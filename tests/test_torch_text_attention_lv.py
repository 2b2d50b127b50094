"""The teacher's LV attentions (lv, lv_vkv, text_dom, ...) and the Sematic
proposal attention against the JAX package's modules; split from
tests/test_torch_text_attention.py so that each file is a small share of
one xdist worker."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    attention as jatt,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    attention as tatt,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models.text_heads import (
    paint_semantic_map,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    GTInstances,
)
from tests.test_torch_text_attention import (  # noqa: F401
    C,
    D,
    SEM,
    OUT_RTOL,
    bank,
    bg,
    check,
    port_state,
)


def test_sematic_proposal_attention_matches_jax():
    rng = np.random.RandomState(3)
    feat = rng.randn(10, D).astype(np.float32)
    w = rng.randn(10, D).astype(np.float32)
    for key in (None, "sim2stext"):
        jmod = jatt.SematicProposalAttention(
            input_size=D, class_embed=bank(), bg_embed=bg())
        tmod = tatt.SematicProposalAttention(D, bank(), bg())
        ww = w if key else rng.randn(1, 10, C + 2).astype(np.float32)
        check(jmod, tmod, [jnp.asarray(feat)], [torch.from_numpy(feat)], ww,
              pick=(lambda o, k=key: o[1][k]) if key else (lambda o: o[0]))


@pytest.mark.parametrize("kind", ["lv", "lv_vkv", "text_dom",
                                  "text_dom_vkv"])
def test_lv_attentions_match_jax(kind):
    """The teacher's attentions over every ROI as one sequence: pad rows
    masked out of the keys; labels in [0, C] (C background) and -1
    (ignore: the background bucket)."""
    rng = np.random.RandomState(4)
    n = 12
    feat = rng.randn(n, D).astype(np.float32)
    labels = rng.randint(-1, C + 1, n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[9:] = False
    jcls = (jatt.LVAttention if kind.startswith("lv")
            else jatt.LVAttentionTextDomination)
    tcls = (tatt.LVAttention if kind.startswith("lv")
            else tatt.LVAttentionTextDomination)
    vkv = kind.endswith("vkv")
    jmod = jcls(input_size=D, class_embed=bank(), vkv=vkv)
    for key in ("sim2stext", "text_feat"):
        tmod = tcls(D, bank(), vkv=vkv)
        pick = lambda o, k=key: o[1][k]  # noqa: E731
        width = D if key == "sim2stext" else (D if kind.startswith("lv")
                                              else SEM)
        w = rng.randn(n, width).astype(np.float32)
        args = [jnp.asarray(feat), jnp.asarray(labels), jnp.asarray(valid)]
        targs = [torch.from_numpy(feat), torch.from_numpy(labels).long(),
                 torch.from_numpy(valid)]
        if key == "sim2stext":
            check(jmod, tmod, args, targs, w, pick)
        else:  # the gathered text feature: no gradient to every parameter
            params = jmod.init(jax.random.PRNGKey(0), *args)["params"]
            tmod.load_state_dict(port_state(params))
            np.testing.assert_allclose(
                pick(tmod(*targs)).detach().numpy(),
                np.asarray(pick(jmod.apply({"params": params}, *args))),
                rtol=OUT_RTOL, atol=1e-6)
    # a pad row's features reach no other row: changing them moves only
    # their own outputs
    tmod = tcls(D, bank(), vkv=vkv)
    tmod.load_state_dict(port_state(
        jmod.init(jax.random.PRNGKey(0), *args)["params"]))
    a = tmod(*targs)[1]["sim2stext"]
    feat2 = feat.copy()
    feat2[9:] += 5.0
    b = tmod(torch.from_numpy(feat2), *targs[1:])[1]["sim2stext"]
    torch.testing.assert_close(a[:9], b[:9], rtol=0, atol=0)
