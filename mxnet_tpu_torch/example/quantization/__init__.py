"""INT8 post-training quantization example (``quantize_model.py``)."""
