"""Reward-model entry point: ``python -m paddlenlp_tpu_torch.llm.alignment.rm.run_rm args.json``."""
