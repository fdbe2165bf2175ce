"""The parameter-serving read tier (``pytorch_ps_mpi_tpu/serving``):
versioned snapshots, delta reads, admission control, and the
:class:`ServingCore` the serve loop, the shard servers and the read-only
replicas share.

- :mod:`.snapshots`: immutable, refcounted snapshots in a ring of the
  last K publishes, fanned out zero-copy;
- :mod:`.delta`: "I have v, give me v -> latest" as an exact sparse or
  dense delta (lossy codecs opt-in behind a fidelity probe), or a full
  snapshot when v aged out;
- :mod:`.net`: the PSR1 wire, the event-loop read server (admission
  shedding, coalescing) and the :class:`ServingReader` client;
- :mod:`.native_read`: the C++ epoll read tier of ``native/tcpps.cpp``;
- :mod:`.core`: :class:`ServingCore`, tenants and the read path;
- :mod:`.follower`: :class:`FollowerLoop`, the replica tree.

Host code: it runs on numpy and sockets, and a lossy delta codec's
kernels run on the device the core or reader is given.
"""

from pytorch_ps_mpi_tpu_torch.serving.core import (DEFAULT_TENANT,
                                                   SERVING_KNOBS,
                                                   ServingCore)
from pytorch_ps_mpi_tpu_torch.serving.delta import DELTA_KNOBS, DeltaCodec
from pytorch_ps_mpi_tpu_torch.serving.follower import FollowerLoop
from pytorch_ps_mpi_tpu_torch.serving.net import (ReadClient, ReadTierServer,
                                                  ServingReader)
from pytorch_ps_mpi_tpu_torch.serving.snapshots import (Snapshot,
                                                        SnapshotStore)

__all__ = [
    "DEFAULT_TENANT",
    "SERVING_KNOBS",
    "ServingCore",
    "DELTA_KNOBS",
    "DeltaCodec",
    "FollowerLoop",
    "ReadClient",
    "ReadTierServer",
    "ServingReader",
    "Snapshot",
    "SnapshotStore",
]
