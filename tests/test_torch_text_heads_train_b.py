"""The port's text-family heads trained against the JAX package's:
test_text_heads_train_like_jax on TRAIN_CASES[3:5] of
tests/test_torch_text_heads.py (every loss and gradient), and
MODEL.ADDITION.FREEZEATTENTION; split from that file so that each file is
a small share of one xdist worker."""

import pytest

import jax
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_optimizer,
    param_groups,
)
from tests.test_torch_text_heads import (  # noqa: F401
    TRAIN_CASES,
    check_train_case,
    jax_batch,
    jax_model,
    port_model,
)


def test_freeze_attention_stops_the_update_not_the_gradient(tmp_path):
    """MODEL.ADDITION.FREEZEATTENTION: the attention's parameters are in no
    optimizer group and do not move, and res5 still gets the gradient
    that flows through them; the FFN's LayerNorm is in the norm group."""
    _, params = jax_model(head="SematicRes5ROIHeads")
    cfg = get_cfg()
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    _, _, timages, tgt = jax_batch(True)
    moved = {}
    for flag in (False, True):
        cfg.MODEL.ADDITION.FREEZEATTENTION = flag
        model = port_model("GeneralizedRCNN", params,
                           head="SematicRes5ROIHeads")
        groups = param_groups(cfg, model)
        names = {k: {n for n, _ in v} for k, v in groups.items()}
        att = {n for n, _ in model.named_parameters()
               if n.startswith("roi_heads.attention.")}
        norm3 = {"roi_heads.attention.attention.ffn.norm3.weight",
                 "roi_heads.attention.attention.ffn.norm3.bias"}
        if flag:
            assert not att & set().union(*names.values())
        else:
            assert norm3 <= names["norm"]
            assert att - norm3 <= names["regular"] | names["bias"]
        opt = build_optimizer(cfg, model)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        # only the attention CE: its gradient reaches res5 only through the
        # attention
        loss = model.forward_train(timages, tgt,
                                   torch.Generator().manual_seed(0))
        opt.zero_grad()
        loss["loss_attentive"].backward()
        res5 = dict(model.named_parameters())["roi_heads.res5.0.conv3.weight"]
        assert float(res5.grad.abs().max()) > 0
        assert float(model.roi_heads.attention.attention.w_q.weight.grad
                     .abs().max()) > 0
        live = {n for n, p in model.named_parameters()
                if n in att and p.grad is not None}
        opt.step()
        moved[flag] = {n for n, p in model.named_parameters()
                       if not torch.equal(p, before[n])}
        assert live and (not flag) == (live <= moved[flag])
    assert not att & moved[True]
    assert "roi_heads.res5.0.conv3.weight" in moved[True]


@pytest.mark.parametrize("head,cosine", TRAIN_CASES[3:5])
def test_text_heads_train_like_jax(head, cosine):
    check_train_case(head, cosine)
