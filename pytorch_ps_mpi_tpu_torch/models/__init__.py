"""Models of the port: MLP, ResNet-18/50 (GroupNorm or BatchNorm), BERT
(MLM), GPT (causal LM) and the Switch MoE MLM."""

from pytorch_ps_mpi_tpu_torch.models.bert import (BertConfig, BertMLM,
                                                  mlm_loss,
                                                  stack_layer_params,
                                                  target_log_likelihood)
from pytorch_ps_mpi_tpu_torch.models.gpt import (GPTLM, causal_lm_loss,
                                                 gpt_config, gpt_tiny)
from pytorch_ps_mpi_tpu_torch.models.mlp import MLP
from pytorch_ps_mpi_tpu_torch.models.moe import SwitchConfig, SwitchMLM
from pytorch_ps_mpi_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50

__all__ = ["BertConfig", "BertMLM", "GPTLM", "MLP", "ResNet", "ResNet18",
           "ResNet50", "SwitchConfig", "SwitchMLM", "causal_lm_loss",
           "gpt_config", "gpt_tiny", "mlm_loss", "stack_layer_params",
           "target_log_likelihood"]
