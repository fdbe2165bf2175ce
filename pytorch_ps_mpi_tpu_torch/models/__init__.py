"""Models of the port: MLP, ResNet-18/50 (GroupNorm or BatchNorm) and BERT
(MLM)."""

from pytorch_ps_mpi_tpu_torch.models.bert import (BertConfig, BertMLM,
                                                  mlm_loss,
                                                  target_log_likelihood)
from pytorch_ps_mpi_tpu_torch.models.mlp import MLP
from pytorch_ps_mpi_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50

__all__ = ["BertConfig", "BertMLM", "MLP", "ResNet", "ResNet18", "ResNet50",
           "mlm_loss", "target_log_likelihood"]
