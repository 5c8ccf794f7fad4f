"""Data tools of the PyTorch port (``llm/tools/`` of the repository)."""
