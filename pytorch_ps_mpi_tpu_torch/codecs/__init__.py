"""Gradient codecs: the pluggable compression surface
(``pytorch_ps_mpi_tpu/codecs``). This package registers ``identity``,
``bf16``, ``f16``, ``sign``, ``int8``, ``qsgd``, ``topk`` and ``ef``; the
others follow in ROADMAP queue 1 item 3."""

from pytorch_ps_mpi_tpu_torch.codecs.base import Codec, get_codec, register_codec
from pytorch_ps_mpi_tpu_torch.codecs.identity import IdentityCodec
from pytorch_ps_mpi_tpu_torch.codecs.cast import Bf16Codec, F16Codec
from pytorch_ps_mpi_tpu_torch.codecs.sign import SignCodec
from pytorch_ps_mpi_tpu_torch.codecs.quant import Int8Codec, QSGDCodec
from pytorch_ps_mpi_tpu_torch.codecs.topk import TopKCodec
from pytorch_ps_mpi_tpu_torch.codecs.error_feedback import ErrorFeedback

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
]
