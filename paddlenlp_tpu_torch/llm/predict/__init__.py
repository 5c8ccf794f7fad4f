"""The predictor and its HTTP server (``llm/predict/`` of the repository)."""
