"""Alignment entry points of the PyTorch port (``llm/alignment/`` of the
repository): ``dpo.run_dpo``, ``rm.run_rm``, ``ppo.run_ppo`` and their shared
preference loader."""
