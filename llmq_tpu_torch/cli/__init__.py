"""cli layer of the PyTorch port (see ``llmq_tpu_torch/__init__.py``)."""
