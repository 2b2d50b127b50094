"""The port's module zoo (``models/modules_zoo.py``) and ``dandr_loss``
(``utils/kdloss.py``) against the JAX package's, on the CPU: values within
1e-5 (relative, with a small absolute floor), the unrolled Sinkhorn
gradient and the ``optimal_transport`` implicit gradients (approx, full,
block; dM, dr and dc) against ``jax.grad`` of the JAX functions within
1e-4 relative, and the student gradient of ``dandr_loss``. Templates:
tests/test_modules_zoo.py and the zoo cases of
tests/test_reference_oracles.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    modules_zoo as jz,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.utils.kdloss import (
    dandr_loss as jax_dandr_loss,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    modules_zoo as tz,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.utils.kdloss import (
    dandr_loss,
)

RTOL = 1e-5
GRAD_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(ours, ref, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(
        ours.detach().numpy() if torch.is_tensor(ours) else ours,
        np.asarray(ref), rtol=rtol, atol=atol)


def _ot_inputs(seed=0, b=2, h=4, w=6):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w).astype(np.float32),
            (rng.rand(b, h) + 0.5).astype(np.float32),
            (rng.rand(b, w) + 0.5).astype(np.float32))


@pytest.mark.parametrize("marginals", [False, True])
@pytest.mark.parametrize("logspace", [False, True])
def test_sinkhorn_matches_jax(marginals, logspace):
    M, r, c = _ot_inputs(1)
    if logspace:
        M = M + 0.5
    r, c = (r, c) if marginals else (None, None)
    ref = jz.sinkhorn(jnp.asarray(M), None if r is None else jnp.asarray(r),
                      None if c is None else jnp.asarray(c), 3.0, 50,
                      logspace)
    ours = tz.sinkhorn(_t(M), None if r is None else _t(r),
                       None if c is None else _t(c), 3.0, 50, logspace)
    _close(ours, ref)
    if marginals:  # the constraints hold
        np.testing.assert_allclose(ours.sum(1).numpy(),
                                   c / c.sum(1, keepdims=True), atol=1e-4)


def test_sinkhorn_unrolled_gradient_matches_jax():
    M, _, _ = _ot_inputs(2)
    w = np.random.RandomState(3).randn(*M.shape).astype(np.float32)
    g_ref = jax.grad(lambda m: jnp.sum(
        jz.sinkhorn(m, None, None, 2.0, 30) * w))(jnp.asarray(M))
    Mt = _t(M).requires_grad_(True)
    (tz.sinkhorn(Mt, None, None, 2.0, 30) * _t(w)).sum().backward()
    _close(Mt.grad, g_ref, rtol=GRAD_RTOL, atol=1e-7)


@pytest.mark.parametrize("method", ["approx", "full", "block"])
def test_optimal_transport_gradients_match_the_jax_custom_vjp(method):
    M, r, c = _ot_inputs(4)
    w = np.random.RandomState(5).randn(*M.shape).astype(np.float32)

    def jloss(m, rr, cc):
        return jnp.sum(jz.optimal_transport(m, rr, cc, 1.5, 100, False,
                                            method) * w)

    ref_val = jz.optimal_transport(jnp.asarray(M), jnp.asarray(r),
                                   jnp.asarray(c), 1.5, 100, False, method)
    gM, gr, gc = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(M), jnp.asarray(r), jnp.asarray(c))
    Mt, rt, ct = (_t(x).requires_grad_(True) for x in (M, r, c))
    P = tz.optimal_transport(Mt, rt, ct, 1.5, 100, False, method)
    _close(P, ref_val)
    (P * _t(w)).sum().backward()
    for ours, ref in ((Mt.grad, gM), (rt.grad, gr), (ct.grad, gc)):
        scale = float(np.abs(np.asarray(ref)).max())
        _close(ours, ref, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)
    if method == "approx":
        assert not rt.grad.any() and not ct.grad.any()
    else:
        assert rt.grad.abs().max() > 0 and ct.grad.abs().max() > 0


def test_optimal_transport_logspace_full_gradient_matches_jax():
    M, _, _ = _ot_inputs(6, b=1, h=3, w=5)
    M = M + 0.5
    gM = jax.grad(lambda m: jnp.sum(jz.optimal_transport(
        m, None, None, 2.0, 80, True, "full") ** 2))(jnp.asarray(M))
    Mt = _t(M).requires_grad_(True)
    (tz.optimal_transport(Mt, None, None, 2.0, 80, True, "full") ** 2
     ).sum().backward()
    _close(Mt.grad, gM, rtol=GRAD_RTOL,
           atol=GRAD_RTOL * float(np.abs(np.asarray(gM)).max()))


def test_similarity_kd_and_label_smoothing_match_jax():
    rng = np.random.RandomState(17)
    a, b2 = rng.randn(6, 9).astype(np.float32), rng.randn(8, 9).astype(
        np.float32)
    _close(tz.sim_matrix(_t(a), _t(b2)), jz.sim_matrix(a, b2))
    ab = rng.randn(3, 5, 9).astype(np.float32)
    bb = rng.randn(3, 7, 9).astype(np.float32)
    _close(tz.bsim_matrix(_t(ab), _t(bb), 2.0), jz.bsim_matrix(ab, bb, 2.0))
    _close(tz.blogits_matrix(_t(ab), _t(bb)), jz.blogits_matrix(ab, bb),
           atol=1e-5)
    logits = (rng.randn(12, 7) * 2).astype(np.float32)
    teacher = (rng.randn(12, 7) * 2).astype(np.float32)
    labels = rng.randint(0, 7, 12)
    _close(tz.loss_fn_kd(_t(logits), _t(labels), _t(teacher), 0.7, 3.0),
           jz.loss_fn_kd(logits, jnp.asarray(labels), teacher, 0.7, 3.0))
    _close(tz.label_smoothing_cross_entropy(_t(logits), _t(labels), 0.1),
           jz.label_smoothing_cross_entropy(logits, jnp.asarray(labels),
                                            0.1))
    _close(tz.label_smoothing_loss(_t(logits), _t(labels), 0.2),
           jz.label_smoothing_loss(logits, jnp.asarray(labels), 0.2))
    assert float(tz.deconv_loss(logits)) == 0.0


def test_dandr_loss_value_and_student_gradient_match_jax():
    rng = np.random.RandomState(5)
    s = (rng.randn(10, 7) * 2).astype(np.float32)
    t = (rng.randn(10, 7) * 2).astype(np.float32)
    y = rng.randint(0, 7, 10)
    y[:3] = 6  # background rows
    args = dict(alpha=1.0, beta=8.0, temperature=2.0)
    ref, g_ref = jax.value_and_grad(lambda x: jax_dandr_loss(
        x, jnp.asarray(t), jnp.asarray(y), **args))(jnp.asarray(s))
    st = _t(s).requires_grad_(True)
    tt = _t(t).requires_grad_(True)
    out = dandr_loss(st, tt, _t(y), **args)
    out.backward()
    _close(out, ref)
    assert out.item() > 0
    _close(st.grad, g_ref, rtol=GRAD_RTOL, atol=1e-7)
    assert tt.grad is None  # the teacher is detached


def test_memory_bank_update_matches_jax():
    rng = np.random.RandomState(23)
    c, cap, d, n = 4, 6, 12, 10
    mem0 = rng.randn(c, cap, d).astype(np.float32)
    instances = rng.randn(n, d).astype(np.float32)
    # the background (== C) updates nothing; class 0 overflows its cap
    classes = np.array([0, 0, 0, 0, 0, 0, 0, 1, 4, 4])
    fixed = rng.randn(15, d).astype(np.float32)
    ref = jz.memory_bank_update(jnp.asarray(mem0), jnp.asarray(instances),
                                jnp.asarray(classes), jnp.asarray(fixed),
                                num_classes=c, k=0.99)
    ours = tz.memory_bank_update(_t(mem0), _t(instances), _t(classes),
                                 _t(fixed), num_classes=c, k=0.99)
    _close(ours, ref)
    np.testing.assert_array_equal(ours[2].numpy(), mem0[2])


@pytest.mark.parametrize("cap", [16, 4])
def test_contrastive_loss_matches_jax(cap):
    rng = np.random.RandomState(19)
    n, c, d = 6, 5, 32  # cap 16: (c-1)*cap > the 40 hardest negatives
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randint(0, c, n)
    mem = rng.randn(c, cap, d).astype(np.float32)
    ref = jz.contrastive_loss(x, jnp.asarray(y), mem, tau=0.07)
    _close(tz.contrastive_loss(_t(x), _t(y), _t(mem), tau=0.07), ref)


def test_feature_generator_matches_jax(monkeypatch):
    c, n, r = 16, 4, 3
    ours = tz.FeatureGenerator(c, repeat_time=r).init_params_(
        torch.Generator().manual_seed(0))
    # the MLP starts near the identity of its input half
    w0 = ours.mlp0.weight.detach()
    assert (w0[:, :c].diagonal() - 1).abs().max() < 0.15
    rng = np.random.RandomState(31)
    x = rng.randn(n, c).astype(np.float32)
    label = np.arange(n)
    noise = rng.randn(n, r, c).astype(np.float32)
    params = {"params": {
        "mean_layer": {"kernel": ours.mean_layer.weight.detach().numpy().T,
                       "bias": ours.mean_layer.bias.detach().numpy()},
        "std_layer": {"kernel": ours.std_layer.weight.detach().numpy().T,
                      "bias": ours.std_layer.bias.detach().numpy() + 0.5},
        "mlp0": {"kernel": w0.numpy().T},
        "mlp1": {"kernel": ours.mlp1.weight.detach().numpy().T},
    }}
    with torch.no_grad():
        ours.std_layer.bias += 0.5  # a std above 0: the noise counts
    # the JAX module's draw of the noise, replaced by the noise the port is
    # given (flax also calls the initialisers abstractly to check shapes)
    normal = jax.random.normal

    def fixed(key, shape, dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fixed)
    ref, ref_lab = jz.FeatureGenerator(input_size=c, repeat_time=r).apply(
        params, jnp.asarray(x), jnp.asarray(label),
        rngs={"generator": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    out, lab = ours(_t(x), _t(label), noise=_t(noise))
    assert out.shape == (n * r, c)
    _close(out, ref)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_lab))


def test_box_augmentation_and_pair_distance_match_jax():
    rng = np.random.RandomState(29)
    for _ in range(5):
        x, y = rng.uniform(0, 200, 2)
        bbox = [x, y, x + rng.uniform(5, 120), y + rng.uniform(5, 120)]
        assert tz.augment_bbox(bbox, (320, 240), 2) == jz.augment_bbox(
            bbox, (320, 240), 2)
    f1 = rng.randn(6, 8).astype(np.float32)
    f2 = rng.randn(9, 8).astype(np.float32)
    _close(tz.pair_l2_distance(_t(f1), _t(f2)), jz.pair_l2_distance(f1, f2),
           atol=1e-5)
