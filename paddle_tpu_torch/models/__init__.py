"""Model families (counterpart of paddle_tpu/models)."""
from .convert import state_dict_from_numpy
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama_7b", "llama_tiny",
           "state_dict_from_numpy"]
