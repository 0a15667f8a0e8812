"""The port's CTC OCR example at its defaults on the CPU (6 epochs,
batch 64, 4096 examples): it reaches its own bar, ``ocr LEARNED``
(per-character test accuracy above 0.5), and exits 0. The comparison
with the JAX example is ``test_torch_ctc_ocr.py``.
"""
import torch

from mxnet_tpu_torch.example.ctc import lstm_ocr


def test_ocr_learns_at_its_defaults(capsys):
    torch.set_num_threads(1)  # one worker's share of the CPU
    assert lstm_ocr.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("ocr LEARNED")
