"""Self-driving control plane — the verdict→action loop.

See :mod:`pytorch_ps_mpi_tpu_torch.control.controller` for the full design:
the :class:`Controller` runs inside the serve loop, turns latched
monitor verdicts into recorded/replayable/reversible actions (codec
renegotiation via wire-epoch bumps, staleness-aware per-push LR
weights, barrier evict/readmit, read-tier tuning), and
:meth:`Controller.replay` re-derives the identical action sequence from
the persisted TSDB input rows.
"""

from pytorch_ps_mpi_tpu_torch.control.controller import (  # noqa: F401
    CONTROL_KNOBS,
    RULES,
    ControlEngine,
    Controller,
    actions_path,
    apply_epoch,
    epoch_path,
    poll_epoch,
    prepare_ladder,
    rung_key,
    write_epoch,
)
