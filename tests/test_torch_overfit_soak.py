"""A plumbing run of the port's soak check on the CPU
(``…_torch/tools/soak_test.py --tiny``): the CLI trains, is stopped by
SIGTERM and resumes to the end.

The two CLI processes run with one intra-op thread each
(``OMP_NUM_THREADS``/``MKL_NUM_THREADS``, as ``test_torch_multiprocess_cli``
pins its ranks): they would otherwise start a thread a core beside every
other test process of a parallel run.
"""

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    soak_test as port_soak,
)


def test_soak_test_tiny_preempts_and_resumes(tmp_path, monkeypatch):
    """Plumbing on the CPU: SIGTERM after iteration 20 of 80, resumed to
    the end through the CLI, every assert of the soak."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    res = port_soak.main(["--tiny", "--device", "cpu", "--iters", "80",
                          "--preempt-at", "20", "--ckpt-period", "10",
                          "--save-dir", str(tmp_path / "soak")])
    assert 20 <= res["sigterm_at"] <= res["leg1_last_iter"] < 79
    assert res["leg1_checkpoints"]
    assert res["loss_last_decile"] < res["loss_first_decile"]
