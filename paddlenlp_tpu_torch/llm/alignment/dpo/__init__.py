"""DPO entry point: ``python -m paddlenlp_tpu_torch.llm.alignment.dpo.run_dpo args.json``."""
