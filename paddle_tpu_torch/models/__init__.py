"""Model families (counterpart of paddle_tpu/models)."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_large, bert_tiny)
from .convert import optimizer_state_from_numpy, state_dict_from_numpy
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt2_small, gpt2_tiny
from .llama import (LlamaConfig, LlamaForCausalLM, blockwise_lm_loss,
                    causal_lm_loss, llama_7b, llama_13b, llama_tiny)
from .trainer import (create_multistep_train_step, create_train_step,
                      run_steps, write_back)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert_base",
           "bert_large", "bert_tiny", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "gpt2_small", "gpt2_tiny", "LlamaConfig",
           "LlamaForCausalLM", "llama_7b", "llama_13b", "llama_tiny",
           "causal_lm_loss", "blockwise_lm_loss", "create_train_step",
           "create_multistep_train_step", "run_steps", "write_back",
           "state_dict_from_numpy", "optimizer_state_from_numpy"]
