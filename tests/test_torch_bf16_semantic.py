"""The Semantic and Distillated families in bfloat16 held to the JAX
package's on the CPU, by the rule of tests/test_torch_bf16_model.py and
the cases of tests/test_torch_bf16_text.py: GeneralizedSemanticRCNN (its
features solely the painted map) and GeneralizedDistillatedRCNN with the
cross-output Sematic head and FastRCNNAttentionOutputLayers (attention in
float32, as in the JAX package): every loss and every parameter's gradient
of one training forward, and the detections of ``forward_inference`` with
test-time GT."""

import pytest

from tests.test_torch_bf16_text import check_inference, check_trains

ARCHS = ["GeneralizedSemanticRCNN", "GeneralizedDistillatedRCNN"]


@pytest.mark.parametrize("meta", ARCHS)
def test_bf16_semantic_meta_arch_trains_like_jax(meta):
    check_trains(meta)


@pytest.mark.parametrize("meta", ARCHS)
def test_bf16_semantic_meta_arch_inference_holds_to_jax(meta):
    check_inference(meta)
