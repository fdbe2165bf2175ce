"""Gradient codecs: the pluggable compression surface
(``pytorch_ps_mpi_tpu/codecs``). This package registers all fourteen
names of the JAX package's registry: ``identity``, ``bf16``, ``f16``,
``sign``, ``int8``, ``qsgd``, ``topk``, ``ef``, ``terngrad``, ``randomk``,
``blocktopk``, ``blocktopk8``, ``threshold`` and ``powersgd``."""

from pytorch_ps_mpi_tpu_torch.codecs.base import Codec, get_codec, register_codec
from pytorch_ps_mpi_tpu_torch.codecs.identity import IdentityCodec
from pytorch_ps_mpi_tpu_torch.codecs.cast import Bf16Codec, F16Codec
from pytorch_ps_mpi_tpu_torch.codecs.sign import SignCodec
from pytorch_ps_mpi_tpu_torch.codecs.quant import Int8Codec, QSGDCodec
from pytorch_ps_mpi_tpu_torch.codecs.topk import TopKCodec
from pytorch_ps_mpi_tpu_torch.codecs.error_feedback import ErrorFeedback
from pytorch_ps_mpi_tpu_torch.codecs.terngrad import TernGradCodec
from pytorch_ps_mpi_tpu_torch.codecs.randomk import RandomKCodec
from pytorch_ps_mpi_tpu_torch.codecs.blocktopk import (BlockTopK8Codec,
                                                       BlockTopKCodec)
from pytorch_ps_mpi_tpu_torch.codecs.threshold import ThresholdCodec
from pytorch_ps_mpi_tpu_torch.codecs.powersgd import PowerSGDCodec

__all__ = [
    "Codec",
    "get_codec",
    "register_codec",
    "IdentityCodec",
    "Bf16Codec",
    "F16Codec",
    "SignCodec",
    "Int8Codec",
    "QSGDCodec",
    "TopKCodec",
    "ErrorFeedback",
    "TernGradCodec",
    "RandomKCodec",
    "BlockTopKCodec",
    "BlockTopK8Codec",
    "ThresholdCodec",
    "PowerSGDCodec",
]
