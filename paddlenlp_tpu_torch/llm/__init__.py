"""Entry points of the PyTorch port (``llm/`` of the repository)."""
