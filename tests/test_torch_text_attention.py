"""The port's text-branch building blocks against the JAX package's, on the
CPU, float32: the attention modules (forward rtol 1e-5, gradients within
1e-4 of their largest value), both init contexts of the siamese attention,
a key mask with pad rows, ``vkv`` on and off, ``loss_fn_kd_only`` with its
1.5x background weighting, ``paint_semantic_map`` (exactly equal), the
class bank and its background vector (exactly equal), and the statistics
of freshly drawn modules.

The same seeded numpy inputs and flax parameters go into both packages;
the parameters cross through ``checkpoint.convert``'s name map of the text
branch, as the full models' do.
"""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    attention as jatt,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models.text_heads import (
    paint_semantic_map as jax_paint,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.utils import (
    class_embedding as jemb,
    class_name as jname,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.convert import (
    _text_path_to_name,
    _to_torch_layout,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
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
from fewshotobjectdetection_imporove_via_text_feature_torch.utils import (
    class_embedding as temb,
    class_name as tname,
)

OUT_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each gradient's largest |value|
C, SEM, D = 5, 16, 32


def bank(c=C, sem=SEM, seed=0):
    rng = np.random.RandomState(seed)
    b = rng.randn(c, sem).astype(np.float32)
    return b / np.linalg.norm(b, axis=1, keepdims=True)


def bg(sem=SEM):
    return np.ones((1, SEM), np.float32) / np.sqrt(sem)


def port_state(params):
    """A flax param tree of one module -> the port module's state dict."""
    out = {}
    for path, value in traverse_util.flatten_dict(params).items():
        name, kind = _text_path_to_name(tuple(map(str, path)))
        out[name] = torch.from_numpy(np.array(
            _to_torch_layout(np.asarray(value), kind)))
    return out


def grads_by_name(grads):
    return {_text_path_to_name(tuple(map(str, p)))[0]:
            _to_torch_layout(np.asarray(g), _text_path_to_name(
                tuple(map(str, p)))[1])
            for p, g in traverse_util.flatten_dict(grads).items()}


def assert_grads_close(module, jgrads):
    ref = grads_by_name(jgrads)
    named = dict(module.named_parameters())
    assert set(named) == set(ref)
    for name, param in named.items():
        want = ref[name]
        got = (np.zeros_like(want) if param.grad is None
               else param.grad.numpy())  # a parameter the output skips
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=GRAD_TOL * float(np.abs(want).max()), err_msg=name)


def check(jmod, tmod, args, targs, weights, pick=lambda out: out[0]):
    """Forward and parameter gradients of sum(pick(out) * weights) through
    both modules; returns the port's outputs."""
    params = jmod.init(jax.random.PRNGKey(0), *args)["params"]
    tmod.load_state_dict(port_state(params))

    def loss(p):
        out = pick(jmod.apply({"params": p}, *args))
        return jnp.sum(out * weights), out

    (_, jout), jg = jax.value_and_grad(loss, has_aux=True)(params)
    tout = pick(tmod(*targs))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=OUT_RTOL, atol=1e-6)
    (tout * torch.from_numpy(np.asarray(weights))).sum().backward()
    assert_grads_close(tmod, jg)
    return tout


@pytest.mark.parametrize("masked", [False, True])
def test_scaled_dot_product_attention_matches_jax(masked):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, n, D).astype(np.float32) for n in (7, 9, 9))
    mask = rng.rand(2, 9) > 0.4 if masked else None
    if masked:
        mask[:, 0] = True
    temp = float(np.sqrt(D))
    jout, jattn = jatt.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), temp,
        None if mask is None else jnp.asarray(mask))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout, tattn = tatt.scaled_dot_product_attention(
        tq, tk, tv, temp, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=OUT_RTOL, atol=1e-6)
    np.testing.assert_allclose(tattn.detach().numpy(), np.asarray(jattn),
                               rtol=OUT_RTOL, atol=1e-7)
    if masked:
        assert (tattn.detach().numpy()[~np.broadcast_to(
            mask[:, None, :], tattn.shape)] == 0).all()
    w = rng.randn(2, 7, D).astype(np.float32)
    jg = jax.grad(lambda a, b, c: jnp.sum(jatt.scaled_dot_product_attention(
        a, b, c, temp, None if mask is None else jnp.asarray(mask))[0] * w),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    (tout * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max())


@pytest.mark.parametrize("reinit,masked", [
    (0.02, False), (0.02, True), (None, False), (None, True)])
def test_siamese_attention_matches_jax(reinit, masked):
    """Both init contexts; a key mask with pad rows; the attention weights
    gain the dummy key's column."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, n, D).astype(np.float32) for n in (6, 8, 8))
    mask = None
    if masked:
        mask = np.ones((2, 8), bool)
        mask[0, 5:] = False
        mask[1, :] = False  # every real key padded: only the dummy is left
    jmod = jatt.SingleHeadSiameseAttention(D, reinit_scale=reinit)
    tmod = tatt.SingleHeadSiameseAttention(D, reinit_scale=reinit)
    args = [jnp.asarray(x) for x in (q, k, v)]
    targs = [torch.from_numpy(x) for x in (q, k, v)]
    if masked:
        args.append(jnp.asarray(mask))
        targs.append(torch.from_numpy(mask))
    w = rng.randn(2, 6, D).astype(np.float32)
    check(jmod, tmod, args, targs, w)
    _, attn = tmod(*targs)
    assert attn.shape == (2, 6, 9)
    if masked:
        np.testing.assert_allclose(attn[1, :, -1].detach().numpy(), 1.0,
                                   rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_kd_only_matches_jax(masked):
    rng = np.random.RandomState(5)
    n = 16
    s, t = rng.randn(n, C + 1).astype(np.float32), rng.randn(
        n, C + 1).astype(np.float32)
    labels = rng.randint(0, C + 1, n).astype(np.int32)
    labels[:3] = C  # background rows
    valid = (rng.rand(n) > 0.3) if masked else None
    jl, jg = jax.value_and_grad(lambda a: jatt.loss_fn_kd_only(
        a, jnp.asarray(labels), C, jnp.asarray(t), temperature=5.0,
        valid=None if valid is None else jnp.asarray(valid)))(jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_()
    tl = tatt.loss_fn_kd_only(
        ts, torch.from_numpy(labels).long(), C, torch.from_numpy(t),
        temperature=5.0,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=OUT_RTOL)
    tl.backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=GRAD_TOL * np.abs(np.asarray(jg)).max())
    # the background rows weigh 1.5: the same rows relabelled foreground
    fg = labels.copy()
    fg[fg == C] = 0
    lf = tatt.loss_fn_kd_only(
        torch.from_numpy(s), torch.from_numpy(fg).long(), C,
        torch.from_numpy(t), temperature=5.0,
        valid=None if valid is None else torch.from_numpy(valid))
    p_t = torch.softmax(torch.from_numpy(t) / 5, 1)
    kl = (p_t * (torch.log_softmax(torch.from_numpy(t) / 5, 1)
                 - torch.log_softmax(torch.from_numpy(s) / 5, 1))).sum(1)
    bgrows = torch.from_numpy(labels == C)
    if valid is not None:
        bgrows = bgrows & torch.from_numpy(valid)
        denom = int(valid.sum())
    else:
        denom = n
    np.testing.assert_allclose(
        (tl - lf).item(), float(0.5 * kl[bgrows].sum() / denom * 25),
        rtol=1e-5)


def _paint_gt():
    """Two images of 5 GT slots: overlapping boxes (three deep), a box
    inside one cell, boxes past the map's edge, an invalid box over the
    others, a class past the bank."""
    boxes = np.array([
        [[0, 0, 64, 64], [32, 32, 96, 96], [40, 8, 120, 70],
         [97.6, 97.6, 104, 104], [0, 0, 128, 128]],
        [[-8, -8, 40, 200], [16, 16, 15.9, 95.9], [30, 30, 90, 90],
         [60, 0, 200, 48], [33, 33, 70, 70]],
    ], np.float32)
    classes = np.array([[0, 2, 4, 1, 3], [1, 0, 7, 2, 3]], np.int32)
    valid = np.array([[True, True, True, True, False],
                      [True, True, True, True, True]])
    return boxes, classes, valid


@pytest.mark.parametrize("adding,inclusive_end,stride", [
    (False, False, 16), (True, False, 16), (False, True, 16),
    (True, False, 4), (False, True, 8)])
def test_paint_semantic_map_is_exactly_jax(adding, inclusive_end, stride):
    boxes, classes, valid = _paint_gt()
    emb = bank(C, SEM, seed=6)
    bgv = bank(1, SEM, seed=7)
    hw = (128 // stride, 160 // stride)
    want = np.asarray(jax_paint(
        JaxGT(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)),
        jnp.asarray(emb), jnp.asarray(bgv), hw, stride=stride,
        adding=adding, inclusive_end=inclusive_end))
    got = paint_semantic_map(
        GTInstances(torch.from_numpy(boxes), torch.from_numpy(classes),
                    torch.from_numpy(valid)),
        torch.from_numpy(emb), torch.from_numpy(bgv), hw, stride=stride,
        adding=adding, inclusive_end=inclusive_end).numpy()
    assert got.shape == want.shape == (2, *hw, SEM)
    np.testing.assert_array_equal(got, want)
    # the invalid box (image 0, slot 4) covers the whole map; it paints
    # nothing: the far corner stays background
    np.testing.assert_array_equal(got[0, -1, -1], bgv[0])


def test_class_names_bank_and_bg_vector_equal_jax():
    for ds in ("voc_2007_trainval_base1", "voc_2007_trainval_novel2_1shot",
               "voc_2007_trainval_all3_2shot_seed4", "coco_trainval_base",
               "coco_trainval_novel_1shot", "coco_trainval_all_10shot",
               "voc_2007_test_all1"):
        tcfg = get_cfg()
        tcfg.DATASETS.TRAIN = (ds,)
        from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
            get_cfg as jget_cfg,
        )
        jcfg = jget_cfg()
        jcfg.DATASETS.TRAIN = (ds,)
        names = tname.get_class_name(tcfg)
        assert names == jname.get_class_name(jcfg), ds
        if ds in ("voc_2007_trainval_base1", "voc_2007_test_all1"):
            assert (tname.get_class_name_test(tcfg)
                    == jname.get_class_name_test(jcfg))
        for model in ("glove", "clip"):
            tb = temb.get_class_embed(names, model, root="/nonexistent")
            jb = jemb.get_class_embed(names, model, root="/nonexistent")
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(
                temb.create_normalized_orthogonal_tensor(tb.mean(0)),
                jemb.create_normalized_orthogonal_tensor(jb.mean(0)))
    assert tname.VOC_GLOVE_NAME_MAP == jname.VOC_GLOVE_NAME_MAP
    assert tname._voc_split_id("x_all3_t_train", "all") == 3


def test_class_bank_reads_files_and_logs_the_synthetic_ones(tmp_path,
                                                            caplog):
    (tmp_path / "glove").mkdir()
    vec = np.arange(300, dtype=np.float64) / 300
    np.savetxt(tmp_path / "glove" / "cat.txt", vec)
    with caplog.at_level(logging.WARNING):
        b = temb.get_class_embed(["cat", "dog", "sofa"], "glove",
                                 root=str(tmp_path))
    np.testing.assert_array_equal(b[0], vec.astype(np.float32))
    np.testing.assert_array_equal(
        b, jemb.get_class_embed(["cat", "dog", "sofa"], "glove",
                                root=str(tmp_path)))
    assert "2 of 3 class embeddings are synthetic" in caplog.text
    assert "dog, sofa" in caplog.text
    # every class with its file: the bank is the files' values, nothing
    # synthetic is logged
    np.savetxt(tmp_path / "glove" / "dog.txt", -vec)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        b = temb.get_class_embed(["dog", "cat"], "glove", root=str(tmp_path))
    np.testing.assert_array_equal(b, np.stack([-vec, vec]).astype(np.float32))
    assert "synthetic" not in caplog.text


def _std(t):
    return float(t.detach().double().std())


def test_fresh_modules_draw_the_jax_distributions():
    """``init_params_`` draws each parameter from the JAX package's
    initialiser: the same std (within a few percent at these sizes) and,
    for uniform draws, the same bound."""
    d = 256
    gen = torch.Generator().manual_seed(0)
    x = jnp.zeros((1, 3, d))
    for reinit in (0.02, None):
        t = tatt.SingleHeadSiameseAttention(d, reinit_scale=reinit)
        t.init_params_(gen)
        j = jatt.SingleHeadSiameseAttention(d, reinit_scale=reinit).init(
            jax.random.PRNGKey(0), x, x, x)["params"]
        for name in ("w_q", "w_k", "w_v", "linear1", "linear2", "linear3"):
            js = float(np.asarray(j[name]["kernel"]).std())
            assert abs(_std(getattr(t, name).weight) / js - 1) < 0.05, (
                reinit, name)
        for name in ("linear1", "linear2"):
            js = float(np.asarray(j["ffn"][name]["kernel"]).std())
            assert abs(_std(getattr(t.ffn, name).weight) / js - 1) < 0.05
            assert not getattr(t.ffn, name).bias.any()
        assert abs(_std(t.dummy) - 1) < 0.15
        assert bool((t.ffn.norm3.weight == 1).all())
        if reinit is None:  # U(+-1/sqrt(fan_in)), not the N(0, 0.02)
            bound = 1 / np.sqrt(d)
            assert float(t.linear1.weight.abs().max()) <= bound
            assert float(t.linear1.weight.abs().max()) > 0.95 * bound
    lv = tatt.LVAttention(d, bank(C, 300))
    lv.init_params_(gen)
    bound = 1 / np.sqrt(2 * d)
    assert float(lv.proj_k.weight.abs().max()) <= bound
    assert not lv.proj_k.bias.any() and not lv.proj2.bias.any()
    assert abs(_std(lv.w_bg) - 1) < 0.15
    assert abs(_std(lv.attention.w_q.weight) / 0.02 - 1) < 0.05
