"""The PCB extractor's two Adam steps at R-101 against the JAX tool's
(``…_torch/tools/train_pcb_extractor.py``); split from
tests/test_torch_generalization_tools.py so that each file is a small
share of one xdist worker."""

import re

import numpy as np
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    train_pcb_extractor as port_pcb,
)
from tests.test_torch_generalization_tools import (  # noqa: F401
    small_voc,
)


def _tv_state(params, names):
    """A flax TorchvisionResNet's parameters under torchvision names (the
    JAX tool's export: HWIO -> OIHW convolutions, (in, out) -> (out, in)
    linears)."""
    from flax import traverse_util

    from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation.archs import (
        tv_translate,
    )

    flat = traverse_util.flatten_dict(params)
    out = {}
    for name in names:
        path, kind = tv_translate(name)
        v = np.asarray(flat[path])
        if kind == "conv":
            v = v.transpose(3, 2, 0, 1)
        elif kind == "linear":
            v = v.T
        out[name] = np.ascontiguousarray(v)
    assert len(out) == len(flat)
    return out


def test_two_adam_steps_equal_the_jax_tool_s(small_voc):
    """From the JAX package's init, loaded into the port under the tool's
    exported names, two Adam steps of the JAX tool's train step and of
    ``train_extractor`` on the same batches (R-101, 32x32 crops, batch 2,
    float32): every tensor within 1e-5 of its largest value, and every
    FrozenBN leaf trained on both sides.

    Adam's eps is 1e-2 here on both sides, not the tools' 1e-8: at 1e-8 the
    first steps move every element by lr times the sign of its gradient,
    and float32 summation noise decides that sign wherever a gradient is
    near zero (30-68% of a tensor's elements lie below 1e-8). Measured on
    the CPU: the first step's gradients agree within 1.3e-6 of their
    largest values, while after two steps at eps 1e-8, 310 of the 522
    tensors differ by more than 1e-5."""
    import jax
    import jax.numpy as jnp
    import optax

    from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation.archs import (
        TorchvisionResNet,
        torchvision_r101_manifest,
    )

    eps, lr, batch, iters = 1e-2, 1e-3, 2, 2
    xs, ys, _ = port_pcb.collect_crops(small_voc, 32)
    xf = port_pcb.normalize(xs)
    model = TorchvisionResNet(depth=101)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 32, 32, 3)))["params"]
    names = torchvision_r101_manifest()
    init = _tv_state(jax.device_get(params), names)

    # the JAX tool's step, with its optimizer at this eps
    tx = optax.adam(lr, eps=eps)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            logits, _ = model.apply({"params": p}, xb)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, yb).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.RandomState(0)
    jax_losses = []
    for _ in range(iters):
        idx = rng.choice(len(xf), size=batch, replace=False)
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(xf[idx]),
                                       jnp.asarray(ys[idx]))
        jax_losses.append(float(loss))
    want = _tv_state(jax.device_get(params), names)

    state, accs, losses = port_pcb.train_extractor(
        xs, ys, iters, batch, lr, 0, torch.device("cpu"), init_state=init,
        eps=eps)
    got = port_pcb.export_state(state)
    assert sorted(got) == sorted(names) and len(names) == 522
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert len(accs) == iters
    bad = {}
    for name in names:
        g = got[name].numpy()
        assert g.dtype == np.float32 and g.shape == want[name].shape
        err = np.abs(g - want[name]).max() / max(np.abs(want[name]).max(),
                                                 1e-30)
        if err > 1e-5:
            bad[name] = err
    assert not bad, bad
    bn = [n for n in names if re.search(r"(bn\d|downsample\.1)\.", n)]
    assert len(bn) == 4 * 104
    for name in bn:
        assert np.abs(want[name] - init[name]).max() > 0, name
        assert np.abs(got[name].numpy() - init[name]).max() > 0, name
