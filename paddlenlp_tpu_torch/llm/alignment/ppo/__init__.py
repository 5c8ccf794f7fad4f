"""PPO entry point: ``python -m paddlenlp_tpu_torch.llm.alignment.ppo.run_ppo args.json``."""
