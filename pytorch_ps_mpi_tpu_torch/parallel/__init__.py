"""Parallel training helpers of the port: the functional data-parallel
step (``dp.make_sync_train_step``)."""

from pytorch_ps_mpi_tpu_torch.parallel.dp import make_sync_train_step

__all__ = ["make_sync_train_step"]
