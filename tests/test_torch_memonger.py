"""The port's ``example/memcost/memonger.py`` on the CPU at a small depth
and width: both findings run and report their bytes (the fused
TrainStep's ``memory_analysis()``, the ``_foreach`` scan's saved bytes
with and without per-step remat), the scan's gradients with and without
remat agree within 1e-6, and the JAX gate's verdict is the ratio's. On
this eager path the tanh scan keeps only its carries, so remat saves
nothing there (PERF.md): the ratio is 1."""
import numpy as np

from mxnet_tpu_torch.example.memcost import memonger

ARGS = ["--device", "cpu", "--depth", "6", "--width", "32",
        "--batch-size", "64"]


def test_memonger_findings_on_the_cpu(capsys):
    res = memonger.main(ARGS)
    out = capsys.readouterr().out
    assert "finding 1" in out and "finding 2" in out
    ts, scan = res["trainstep_bytes"], res["scan_bytes"]
    assert ts["stored"] > 0 and ts["remat"] < ts["stored"]
    # the D carries after the input, each (batch, width) float32
    assert scan["stored"] == scan["remat"] == 6 * 64 * 32 * 4
    assert res["ratio"] == 1.0 and res["sublinear"] is False
    assert "memonger no saving" in out
    assert res["grad_max_abs_diff"] <= 1e-6
    assert np.isfinite(list(res["scan_seconds"].values())).all()
