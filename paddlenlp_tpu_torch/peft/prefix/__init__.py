from .prefix_model import PrefixConfig, PrefixModelForCausalLM  # noqa: F401
