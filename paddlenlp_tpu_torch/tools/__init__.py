"""Operator entry points of the PyTorch port, run as ``python -m
paddlenlp_tpu_torch.tools.<name>``."""
