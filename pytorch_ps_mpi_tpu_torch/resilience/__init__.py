"""Make every failure of the async PS injectable and survivable
(``pytorch_ps_mpi_tpu/resilience``):

- :mod:`.faults`: the seeded, deterministic :class:`FaultInjector`;
- :mod:`.frames`: self-verifying wire frames and the tree's
  composed-lineage trailer;
- :mod:`.worker`: :class:`ResilientWorker`, backoff and reconnect around
  a transport worker;
- :mod:`.supervisor`: :class:`Supervisor`, worker respawns and server
  restarts from the checkpoint cadence.
"""

from pytorch_ps_mpi_tpu_torch.resilience.faults import (CRASH_EXIT_CODE,
                                                        FAULT_KINDS,
                                                        FaultInjector,
                                                        InjectedServerCrash,
                                                        load_fault_log,
                                                        normalize_plan)
from pytorch_ps_mpi_tpu_torch.resilience.frames import (FRAME_MAGIC,
                                                        FRAME_MAGIC_V1,
                                                        HEADER_BYTES,
                                                        open_frame,
                                                        read_lineage,
                                                        seal_frame,
                                                        wire_fingerprint)
from pytorch_ps_mpi_tpu_torch.resilience.supervisor import Supervisor
from pytorch_ps_mpi_tpu_torch.resilience.worker import ResilientWorker

__all__ = [
    "CRASH_EXIT_CODE", "FAULT_KINDS", "FaultInjector", "InjectedServerCrash",
    "load_fault_log", "normalize_plan", "FRAME_MAGIC", "FRAME_MAGIC_V1",
    "HEADER_BYTES", "open_frame", "read_lineage", "seal_frame",
    "wire_fingerprint", "Supervisor", "ResilientWorker",
]
