"""Parallel training helpers of the port: the functional data-parallel
step (``dp.make_sync_train_step``), and sequence (ring, Ulysses), tensor,
pipeline and expert parallelism over a named mesh (``mesh.Mesh``)."""

from pytorch_ps_mpi_tpu_torch.parallel.dp import make_sync_train_step
from pytorch_ps_mpi_tpu_torch.parallel.ep import moe_apply, moe_dense_oracle
from pytorch_ps_mpi_tpu_torch.parallel.pp import pipeline_apply, pipeline_loss
from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_attention
from pytorch_ps_mpi_tpu_torch.parallel.tp import tp_mlp, tp_self_attention
from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["make_sync_train_step", "moe_apply", "moe_dense_oracle",
           "pipeline_apply", "pipeline_loss", "ring_attention", "tp_mlp",
           "tp_self_attention", "ulysses_attention"]
