"""Attention modules of the text-feature branch, counterpart of the JAX
package's ``models/attention.py`` (ref
defrcn/modeling/roi_heads/attentive_modules.py):

  * ``scaled_dot_product_attention``: softmax(QK^T / temperature) V, keys
    masked out with -inf where ``key_mask`` is False;
  * ``FFN``: linear(d -> 1024), relu, linear(1024 -> d), residual,
    LayerNorm (epsilon 1e-5, torch's default);
  * ``SingleHeadSiameseAttention``: Q/K/V linears without bias, a learned
    "dummy" background key with a zero value appended to the keys, then
    FFN(linear3(cat(linear1(out * q), linear2(q - out), q)));
  * ``SematicProposalAttention``: ROI features attend over the class bank
    plus an orthogonal background vector;
  * ``LVAttention`` (``vkv``: the query is the value): the teacher's
    attention, each ROI's text feature chosen by its GT class, attending
    across every ROI of the batch as one sequence;
  * ``LVAttentionTextDomination`` (``vkv`` too): the same in text space;
  * ``loss_fn_kd_only``: the KL logit distillation, background rows
    weighted 1.5.

The products QK^T and AV are plain ``torch.matmul`` calls and a softmax, as
the JAX package computes them outside any kernel. Every layer here runs in
float32 (the flax layers carry no dtype): callers hand float32 in and cast
what comes out. Linear weights are (out, in); the flax kernels are (in, out).

Each module's ``init_params_(generator)`` draws its parameters as the JAX
package draws them (``checkpoint.init_weights`` calls it): N(0, 0.02) for
every linear of a ``SingleHeadSiameseAttention`` in the Sematic and LV heads
(the reference's ``_init_parameters``), N(0, sqrt(2 / 2d)) Q/K/V and
U(+-1/sqrt(fan_in)) linears as constructed otherwise (the TextAtt pixel
attention), U(+-1/sqrt(fan_in)) projections with zero bias, N(0, 1) for the
dummy token and ``w_bg``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather_with_grad, global_normalizer


def scaled_dot_product_attention(q, k, v, temperature: float,
                                 key_mask: Optional[torch.Tensor] = None):
    """q (B, Lq, D), k and v (B, Lk, D); key_mask (B, Lk) bool, False keys
    get no weight. Returns (out (B, Lq, D), attention weights (B, Lq, Lk))."""
    attn = torch.matmul(q, k.transpose(-1, -2)) / temperature
    if key_mask is not None:
        attn = attn.masked_fill(~key_mask[:, None, :], float("-inf"))
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn, v), attn


def torch_linear_init_(linear: nn.Linear, generator: torch.Generator):
    """U(+-1/sqrt(fan_in)) weight (torch's default Linear draw, as flax's
    ``variance_scaling(1/3, "fan_in", "uniform")``), zero bias."""
    bound = 1.0 / math.sqrt(linear.weight.shape[1])
    nn.init.uniform_(linear.weight, -bound, bound, generator=generator)
    if linear.bias is not None:
        nn.init.zeros_(linear.bias)


def normal_linear_init_(linear: nn.Linear, std: float,
                        generator: torch.Generator):
    nn.init.normal_(linear.weight, 0.0, std, generator=generator)
    if linear.bias is not None:
        nn.init.zeros_(linear.bias)


def _bank(*arrays) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [np.asarray(a, np.float32) for a in arrays], axis=0))


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ffn: int = 1024):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


class SingleHeadSiameseAttention(nn.Module):
    """Single-head attention with a learned dummy background key.
    ``reinit_scale`` 0.02: the Sematic/LV heads' context, every linear
    N(0, 0.02); None: the module as constructed (the TextAtt pixel
    attention)."""

    def __init__(self, d_model: int, reinit_scale: Optional[float] = 0.02):
        super().__init__()
        d = d_model
        self.d_model = d
        self.reinit_scale = reinit_scale
        self.w_q = nn.Linear(d, d, bias=False)
        self.w_k = nn.Linear(d, d, bias=False)
        self.w_v = nn.Linear(d, d, bias=False)
        self.dummy = nn.Parameter(torch.zeros(1, d))
        self.linear1 = nn.Linear(d, d // 2)
        self.linear2 = nn.Linear(d, d // 2)
        self.linear3 = nn.Linear(2 * (d // 2) + d, d)
        self.ffn = FFN(d)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator):
        linears = (self.linear1, self.linear2, self.linear3,
                   self.ffn.linear1, self.ffn.linear2)
        if self.reinit_scale is not None:
            for lin in (self.w_q, self.w_k, self.w_v, *linears):
                normal_linear_init_(lin, self.reinit_scale, generator)
        else:
            std = math.sqrt(2.0 / (2 * self.d_model))
            for lin in (self.w_q, self.w_k, self.w_v):
                normal_linear_init_(lin, std, generator)
            for lin in linears:
                torch_linear_init_(lin, generator)
        nn.init.normal_(self.dummy, 0.0, 1.0, generator=generator)
        nn.init.ones_(self.ffn.norm3.weight)
        nn.init.zeros_(self.ffn.norm3.bias)

    def forward(self, q, k, v, key_mask=None):
        """q (B, Lq, d), k and v (B, Lk, d), key_mask (B, Lk) or None ->
        (out (B, Lq, d), attention weights (B, Lq, Lk + 1))."""
        b, d = q.shape[0], self.d_model
        residual = q
        qp, kp, vp = self.w_q(q), self.w_k(k), self.w_v(v)
        kp = torch.cat([kp, self.dummy[None].expand(b, 1, d)], dim=1)
        vp = torch.cat([vp, vp.new_zeros(b, 1, d)], dim=1)
        if key_mask is not None:  # the dummy key is always attendable
            key_mask = torch.cat(
                [key_mask, key_mask.new_ones(b, 1)], dim=1)
        out, attn = scaled_dot_product_attention(
            qp, kp, vp, float(np.sqrt(d)), key_mask)
        o1 = F.relu(self.linear1(out * residual))
        o2 = F.relu(self.linear2(residual - out))
        merged = self.linear3(torch.cat([o1, o2, residual], dim=-1))
        return self.ffn(merged), attn


class SematicProposalAttention(nn.Module):
    """ROI features (N, input_size) attend over the (C + 1, sem) bank of
    class embeddings and the background vector; returns (attention weights
    (1, N, C + 2), {"sim2stext": (N, input_size), "text_feat": the bank})."""

    def __init__(self, input_size: int, class_embed, bg_embed):
        super().__init__()
        bank = _bank(class_embed, bg_embed)
        self.register_buffer("bank", bank, persistent=False)
        sem = bank.shape[1]
        self.key_projection = nn.Linear(sem, input_size)
        self.value_projection = nn.Linear(sem, input_size)
        self.attention = SingleHeadSiameseAttention(input_size)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator):
        # the projections keep torch's default draw: the reference's
        # re-initialisation touches the attention only
        torch_linear_init_(self.key_projection, generator)
        torch_linear_init_(self.value_projection, generator)
        self.attention.init_params_(generator)

    def forward(self, visual_feat):
        k = F.relu(self.key_projection(self.bank))
        v = F.relu(self.value_projection(self.bank))
        sim2stext, attn = self.attention(visual_feat[None], k[None], v[None])
        return attn, {"sim2stext": F.relu(sim2stext[0]),
                      "text_feat": self.bank}


def _keys(text_feat, value, valid, across_ranks: bool):
    """The teacher's keys (1, L, d), values and key mask (1, L) or None:
    this batch's ROIs, or with ``across_ranks`` every rank's in rank
    order."""
    if across_ranks:
        text_feat = all_gather_with_grad(text_feat)
        value = all_gather_with_grad(value)
        if valid is not None:
            valid = all_gather_with_grad(valid.to(torch.uint8)).bool()
    return (text_feat[None], value[None],
            None if valid is None else valid[None])


class LVAttention(nn.Module):
    """The teacher's attention: each ROI's text feature is the projected
    embedding of its GT class (pad and ignore rows: the background
    bucket), the value proj(cat(visual, text)); every ROI of the batch
    attends over all of them as one sequence, pad rows masked out of the
    keys. ``vkv``: the query is the value. ``across_ranks``: the keys, the
    values and their mask are every rank's, gathered with their gradient,
    so each ROI attends over the global batch as under the JAX package's
    pjit; the queries stay local."""

    def __init__(self, input_size: int, class_embed, vkv: bool = False):
        super().__init__()
        bank = _bank(class_embed)
        self.register_buffer("class_embed", bank, persistent=False)
        text_dim = bank.shape[1]
        self.vkv = vkv
        self.w_bg = nn.Parameter(torch.zeros(1, text_dim))
        self.proj2 = nn.Linear(text_dim, input_size)
        self.proj_k = nn.Linear(2 * input_size, input_size)
        self.attention = SingleHeadSiameseAttention(input_size)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator):
        nn.init.normal_(self.w_bg, 0.0, 1.0, generator=generator)
        torch_linear_init_(self.proj2, generator)
        torch_linear_init_(self.proj_k, generator)
        self.attention.init_params_(generator)

    def forward(self, visual_feat, gt_classes, valid=None,
                across_ranks: bool = False):
        c = self.class_embed.shape[0]
        embed = self.proj2(torch.cat([self.class_embed, self.w_bg], dim=0))
        text_feat = embed[torch.clamp(gt_classes.long(), 0, c)]
        value = self.proj_k(torch.cat([visual_feat, text_feat], dim=-1))
        # the returned text feature is the gathered projection before relu
        text_out = text_feat
        text_feat, value = F.relu(text_feat), F.relu(value)
        q = value[None] if self.vkv else visual_feat[None]
        k, v, mask = _keys(text_feat, value, valid, across_ranks)
        sim2stext, _ = self.attention(q, k, v, key_mask=mask)
        return {}, {"sim2stext": F.relu(sim2stext[0]), "text_feat": text_out}


class LVAttentionTextDomination(nn.Module):
    """``LVAttention`` carried in text space: the visual feature projected
    to the text width, the attended output projected back."""

    def __init__(self, input_size: int, class_embed, vkv: bool = False):
        super().__init__()
        bank = _bank(class_embed)
        self.register_buffer("class_embed", bank, persistent=False)
        text_dim = bank.shape[1]
        self.vkv = vkv
        self.proj_visual = nn.Linear(input_size, text_dim)
        self.w_bg = nn.Parameter(torch.zeros(1, text_dim))
        self.proj_value = nn.Linear(2 * text_dim, text_dim)
        self.attention = SingleHeadSiameseAttention(text_dim)
        self.proj2 = nn.Linear(text_dim, input_size)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator):
        torch_linear_init_(self.proj_visual, generator)
        nn.init.normal_(self.w_bg, 0.0, 1.0, generator=generator)
        torch_linear_init_(self.proj_value, generator)
        self.attention.init_params_(generator)
        torch_linear_init_(self.proj2, generator)

    def forward(self, visual_feat, gt_classes, valid=None,
                across_ranks: bool = False):
        c = self.class_embed.shape[0]
        vis_t = self.proj_visual(visual_feat)
        embed = torch.cat([self.class_embed, self.w_bg], dim=0)
        text_feat = embed[torch.clamp(gt_classes.long(), 0, c)]
        value = self.proj_value(torch.cat([vis_t, text_feat], dim=-1))
        text_out = text_feat
        text_feat, value = F.relu(text_feat), F.relu(value)
        q = value[None] if self.vkv else vis_t[None]
        k, v, mask = _keys(text_feat, value, valid, across_ranks)
        sim2stext, _ = self.attention(q, k, v, key_mask=mask)
        sim2stext = self.proj2(F.relu(sim2stext[0]))
        return {}, {"sim2stext": sim2stext, "text_feat": text_out}


def loss_fn_kd_only(student_logits, labels, bg_label: int, teacher_logits,
                    temperature: float, alpha: float = 1.0, valid=None):
    """KL(teacher || student) at ``temperature``, background rows weighted
    1.5, mean over the valid rows (the global batch's count), times
    temperature^2 * alpha (ref my_module.py:408-437)."""
    t = temperature
    logp_s = torch.log_softmax(student_logits / t, dim=1)
    p_t = torch.softmax(teacher_logits / t, dim=1)
    logp_t = torch.log_softmax(teacher_logits / t, dim=1)
    kl = torch.sum(p_t * (logp_t - logp_s), dim=1)
    kl = torch.where(labels == bg_label, kl * 1.5, kl)
    if valid is not None:
        kl = torch.where(valid, kl, torch.zeros_like(kl))
        denom = global_normalizer(valid.sum())
    else:
        denom = labels.shape[0]
    return kl.sum() / denom * t * t * alpha
