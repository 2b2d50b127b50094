"""The knowledge-distillation and miscellaneous module zoo of the text
branch (ref defrcn/modeling/roi_heads/my_module.py), in PyTorch.

Counterpart of the JAX package's ``models/modules_zoo.py``:
  * ``sinkhorn`` (a plain loop, differentiable by autograd through it) and
    ``optimal_transport``, whose backward is the DDN implicit gradient
    (``approx``, ``full`` or ``block``, as ``_ot_bwd`` there);
  * the similarity matrices, label-smoothing losses and ``loss_fn_kd``;
  * ``memory_bank_update`` (EMA class banks) and ``contrastive_loss``;
  * ``FeatureGenerator`` with the JAX package's initialisers;
  * ``augment_bbox`` and ``pair_l2_distance``; the ``deconv_loss`` stub.

No model of either package calls these; the tests hold them to the JAX
package's.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


# --------------------------------------------------------------------------
# Sinkhorn / optimal transport
# --------------------------------------------------------------------------
def _marginal(x, n, b, like):
    if x is None:
        return torch.full((b, n), 1.0 / n, dtype=like.dtype,
                          device=like.device)
    return x / x.sum(dim=1, keepdim=True)


def sinkhorn(M, r=None, c=None, gamma=1.0, maxiters=100, logspace=False):
    """Entropy-regularised OT by Sinkhorn row and column normalisation.
    M (B, H, W); r (B, H) or None (uniform); c (B, W) or None."""
    b, h, w = M.shape
    r = _marginal(r, h, b, M)
    c = _marginal(c, w, b, M)
    if logspace:
        P = torch.pow(M, gamma)
    else:
        P = torch.exp(-gamma * (M - M.amin(dim=2, keepdim=True)))
    for _ in range(maxiters):
        alpha = P.sum(dim=2, keepdim=True)
        P = P / torch.clamp(alpha, min=1e-30) * r[:, :, None]
        beta = P.sum(dim=1, keepdim=True)
        P = P / torch.clamp(beta, min=1e-30) * c[:, None, :]
    return P


def _ot_backward(M, r, c, P, dP, gamma, logspace, method):
    """The DDN implicit gradient of ``sinkhorn`` -> (dM, dr, dc)."""
    b, h, w = M.shape
    dM = -gamma * P * dP
    if method == "approx":
        return (dM, None if r is None else torch.zeros_like(r),
                None if c is None else torch.zeros_like(c))
    # eliminate the KKT multipliers of the row (rows 1..H-1; row 0 is
    # redundant) and column constraints
    alpha = P.sum(dim=2)  # (B, H)
    beta = P.sum(dim=1)   # (B, W)
    vhat1 = dM[:, 1:, :].sum(dim=2)  # (B, H-1)
    vhat2 = dM.sum(dim=1)            # (B, W)
    if method == "full":
        top = torch.cat([torch.diag_embed(alpha[:, 1:]), P[:, 1:, :]], dim=2)
        bot = torch.cat([P[:, 1:, :].transpose(1, 2),
                         torch.diag_embed(beta)], dim=2)
        K = torch.cat([top, bot], dim=1)
        v = torch.linalg.solve(K.transpose(1, 2),
                               torch.cat([vhat1, vhat2], dim=1)[..., None])
        v = v[..., 0]
        v1, v2 = v[:, : h - 1], v[:, h - 1:]
    elif method == "block":
        # the Schur complement of the diag(beta) block
        p_div_c = P[:, 1:, :] / beta[:, None, :]  # (B, H-1, W)
        schur = torch.diag_embed(alpha[:, 1:]) - torch.einsum(
            "bij,bkj->bik", P[:, 1:, :], p_div_c)
        L = torch.linalg.cholesky(schur)
        b12 = torch.cholesky_solve(p_div_c, L)  # (B, H-1, W)
        b22 = torch.diag_embed(1.0 / beta) + torch.einsum(
            "bji,bjk->bik", b12, p_div_c)  # (B, W, W)
        v1 = torch.cholesky_solve(vhat1[..., None], L)[..., 0] \
            - torch.einsum("bi,bji->bj", vhat2, b12)
        v2 = torch.einsum("bi,bij->bj", vhat2, b22) \
            - torch.einsum("bi,bij->bj", vhat1, b12)
    else:
        raise ValueError(f"unknown OT gradient method {method!r}")
    dM = torch.cat([dM[:, :1], dM[:, 1:] - v1[:, :, None] * P[:, 1:]], dim=1)
    dM = dM - v2[:, None, :] * P
    if logspace:
        dM = dM / (-M)
    dr = dc = None
    if r is not None:
        inv_r_sum = 1.0 / r.sum(dim=1, keepdim=True)
        rn = r * inv_r_sum
        dr = inv_r_sum / gamma * (
            (rn[:, 1:] * v1).sum(dim=1, keepdim=True)
            - torch.cat([torch.zeros_like(v1[:, :1]), v1], dim=1))
    if c is not None:
        inv_c_sum = 1.0 / c.sum(dim=1, keepdim=True)
        cn = c * inv_c_sum
        dc = inv_c_sum / gamma * ((cn * v2).sum(dim=1, keepdim=True) - v2)
    return dM, dr, dc


class OptimalTransport(torch.autograd.Function):
    """``sinkhorn`` forward, the DDN implicit gradient backward
    (ref OptimalTransportFcn, my_module.py:198-329)."""

    @staticmethod
    def forward(ctx, M, r, c, gamma, maxiters, logspace, method):
        with torch.no_grad():
            P = sinkhorn(M, r, c, gamma, maxiters, logspace)
        ctx.save_for_backward(M, r, c, P)
        ctx.args = (gamma, logspace, method)
        return P

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dP):
        M, r, c, P = ctx.saved_tensors
        dM, dr, dc = _ot_backward(M, r, c, P, dP, *ctx.args)
        return dM, dr, dc, None, None, None, None


def optimal_transport(M, r=None, c=None, gamma=1.0, maxiters=100,
                      logspace=False, method="approx"):
    """OT with the DDN implicit gradient. ``method``:

      * 'approx': dJ/dM = -gamma * P * dJ/dP (exact only when exp(-gamma M)
        is already close to doubly stochastic);
      * 'full': the exact implicit gradient from the dense (H+W-1)^2 KKT
        system (``torch.linalg.solve``);
      * 'block': the same gradient through the Schur complement
        (a Cholesky factor of the (H-1)^2 block), cheaper when W >> H.

    'full' and 'block' also give dJ/dr and dJ/dc when r and c are given. A
    singular system gives non-finite gradients, as in the JAX package (the
    reference skips such a sample with a warning). For the unrolled
    gradient, call ``sinkhorn``."""
    return OptimalTransport.apply(M, r, c, gamma, maxiters, logspace, method)


# --------------------------------------------------------------------------
# Similarity matrices (my_module.py:440-469)
# --------------------------------------------------------------------------
def _norm(a, eps=1e-12):
    return a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                           min=eps)


def sim_matrix(a, b, eps=1e-12):
    return _norm(a, eps) @ _norm(b, eps).T


def bsim_matrix(a, b, tau=1.0):
    return torch.einsum("bik,bjk->bij", _norm(a), _norm(b)) * tau


def blogits_matrix(a, b):
    m = torch.einsum("bik,bjk->bij", a, b)
    return m.max() - m


# --------------------------------------------------------------------------
# Label smoothing (my_module.py:939-979) and KD (my_module.py:393-406)
# --------------------------------------------------------------------------
def label_smoothing_cross_entropy(preds, target, epsilon=0.1):
    n = preds.shape[-1]
    logp = F.log_softmax(preds, dim=-1)
    loss = -logp.sum(dim=-1).mean()
    nll = -logp.gather(1, target.long()[:, None])[:, 0].mean()
    return (1 - epsilon) * nll + epsilon * loss / n


def label_smoothing_loss(pred, target, smoothing=0.2):
    n_cls = pred.shape[1]
    logp = F.log_softmax(pred, dim=-1)
    true_dist = torch.full_like(logp, smoothing / (n_cls - 1))
    true_dist = torch.where(
        F.one_hot(target.long(), n_cls).bool(),
        torch.full_like(logp, 1.0 - smoothing), true_dist)
    return torch.mean(torch.sum(-true_dist * logp, dim=-1))


def loss_fn_kd(outputs, labels, teacher_outputs, alpha, temperature):
    t = temperature
    logp_s = F.log_softmax(outputs / t, dim=1)
    p_t = F.softmax(teacher_outputs / t, dim=1)
    logp_t = F.log_softmax(teacher_outputs / t, dim=1)
    kd = torch.mean(p_t * (logp_t - logp_s))  # KLDivLoss: mean of elements
    logp = F.log_softmax(outputs, dim=1)
    ce = -logp.gather(1, labels.long()[:, None])[:, 0].mean()
    return kd * alpha * t * t + ce * (1.0 - alpha)


# --------------------------------------------------------------------------
# EMA memory bank (my_module.py:631-700, update4)
# --------------------------------------------------------------------------
def memory_bank_update(memory, instances, classes, fixed_bank, num_classes,
                       k=0.99):
    """The EMA class-bank update. memory (C, cap, D); instances (N, D);
    classes (N,) in [0, C] (C, the background, updates nothing);
    fixed_bank (M, D). For each class with instances: push them in front of
    its slots (keeping cap), then blend each slot toward its least-similar
    fixed anchor with weight 1 - k."""
    c, cap, _ = memory.shape
    n = instances.shape[0]
    out = []
    for cls in range(c):
        mask = classes == cls
        n_new = int(mask.sum())
        if n_new == 0:
            out.append(memory[cls])
            continue
        # stable: the class's instances first, the others after
        order = torch.argsort((~mask).to(torch.int8), stable=True)
        merged = torch.cat([instances[order], memory[cls]], dim=0)
        idx = torch.arange(cap, device=memory.device)
        take = torch.where(idx < n_new, idx, idx + (n - n_new))
        new_ins = merged[take.clamp(max=merged.shape[0] - 1)]  # (cap, D)
        least = torch.argmin(new_ins @ fixed_bank.T, dim=1)
        out.append(k * new_ins + (1 - k) * fixed_bank[least])
    return torch.stack(out)


# --------------------------------------------------------------------------
# Contrastive loss (my_module.py:1062-1197, call_loss3)
# --------------------------------------------------------------------------
def contrastive_loss(x, y, mem, tau=1e-2, neg_topk=40):
    """InfoNCE against the per-class memory, as the reference's live
    branch: the positive is x_norm . normalize(mean of its class's raw
    slots) / tau; the negatives x_norm . normalize(slot) / tau over the
    other classes' slots, the hardest ``neg_topk`` only; the loss the
    cross entropy at label 0. x (N, D); y (N,) in [0, C); mem (C, cap, D)."""
    n, d = x.shape
    c, cap, _ = mem.shape
    xn = _norm(x)
    memn = _norm(mem)
    class_means = _norm(mem.mean(dim=1))  # the norm of the raw mean
    pos = (xn @ class_means.T / tau).gather(1, y.long()[:, None])  # (N, 1)
    logits_all = xn @ memn.reshape(c * cap, d).T / tau  # (N, C*cap)
    own = torch.arange(c, device=x.device)[None, :] == y.long()[:, None]
    neg_mask = ~own[:, :, None].expand(n, c, cap).reshape(n, c * cap)
    neg = torch.where(neg_mask, logits_all,
                      torch.full_like(logits_all, float("-inf")))
    neg = torch.topk(neg, min(neg_topk, (c - 1) * cap), dim=1).values
    logits = torch.cat([pos, neg], dim=1)
    return -torch.mean(F.log_softmax(logits, dim=1)[:, 0])


# --------------------------------------------------------------------------
# Feature generator (my_module.py:982-1021)
# --------------------------------------------------------------------------
class FeatureGenerator(nn.Module):
    """A noise-conditioned feature hallucinator: for each input, draw
    ``repeat_time`` Gaussian features with a learned mean and std and mix
    them with the input through a near-identity MLP."""

    def __init__(self, input_size: int, repeat_time: int = 16):
        super().__init__()
        c = input_size
        self.repeat_time = repeat_time
        self.mean_layer = nn.Linear(c, 1)
        self.std_layer = nn.Linear(c, 1)
        self.mlp0 = nn.Linear(2 * c, c, bias=False)
        self.mlp1 = nn.Linear(c, c, bias=False)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator):
        """The JAX package's initialisers: flax's lecun normal for the mean
        and std heads (zero biases); eye(out, in) + N(0, 0.02) for the MLP
        (ref init_weights, my_module.py:986-991), so the (2C -> C) layer
        starts as a pass-through of the input half."""
        for lin in (self.mean_layer, self.std_layer):
            std = math.sqrt(1.0 / lin.weight.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            lin.bias.zero_()
        for lin in (self.mlp0, self.mlp1):
            w = lin.weight
            w.copy_(torch.eye(*w.shape) + 0.02 * torch.randn(
                w.shape, generator=generator))
        return self

    def forward(self, x, label, generator=None, noise=None):
        """x (N, C), label (N,) -> (features (N*r, C), labels (N*r,));
        ``noise`` (N, r, C) standard normal, else drawn from
        ``generator``."""
        n, c = x.shape
        r = self.repeat_time
        mean = self.mean_layer(x)  # (N, 1)
        std = F.relu(self.std_layer(x))
        if noise is None:
            noise = torch.randn((n, r, c), generator=generator,
                                dtype=x.dtype, device=x.device)
        z = (mean[:, None, :] + std[:, None, :] * noise).reshape(-1, c)
        h = torch.cat([x.repeat_interleave(r, dim=0), z], dim=1)
        h = F.relu(self.mlp0(h))
        h = F.relu(self.mlp1(h))
        return h, label.repeat_interleave(r, dim=0)


def deconv_loss(*args, **kwargs):
    """A stub returning 0, as the reference's (my_module.py:1331-1336)."""
    return torch.zeros(())


# --------------------------------------------------------------------------
# Box augmentation (my_module.py:1200-1243)
# --------------------------------------------------------------------------
def convert_center_to_xyxy(bbox, image_shape):
    """(cx, cy, w, h) -> XYXY clipped to image_shape = (width, height)
    (ref covert_center2_xywh, which returns XYXY despite its name)."""
    width, height = image_shape
    x_c, y_c, w, h = bbox
    x = max(0.0, x_c - w / 2)
    y = max(0.0, y_c - h / 2)
    return [x, y, min(width, x + w), min(height, y + h)]


def augment_bbox(bbox, image_shape, scale_factor=2):
    """Three clipped variants with the same centre: scaled both ways,
    tall, wide."""
    x, y, x2, y2 = bbox
    w, h = x2 - x, y2 - y
    cx, cy = x + w / 2, y + h / 2
    sw, sh = w * scale_factor, h * scale_factor
    return [convert_center_to_xyxy(bb, image_shape)
            for bb in ([cx, cy, sw, sh], [cx, cy, w, sh], [cx, cy, sw, h])]


def pair_l2_distance(feature1, feature2):
    """Pairwise Euclidean distances (N, M)."""
    d2 = ((feature1[:, None, :] - feature2[None, :, :]) ** 2).sum(dim=-1)
    return torch.sqrt(F.relu(d2))
