"""The per-step metrics schema.

The reference returned a wall-clock and byte-count dict from every
``step`` (``ps.py:116-148,162-191``); the JAX package keeps its keys in
``MPI_PS._schema_dict`` (``pytorch_ps_mpi_tpu/ps.py:1898-1925``). The
port returns the same keys so callers read either package's dict alike.
"""

from __future__ import annotations

from typing import Dict, Union

#: every key of the step metrics dict, in the JAX package's order
SCHEMA_KEYS = (
    "code_wait",
    "iallgather_prepare_time",
    "isend_time",
    "comm_wait",
    "decode_time",
    "optim_step_time",
    "msg_bytes",
    "packaged_bytes",
    "wire_lowering",
    "wire_bytes_per_worker",
    "bucket_count",
    "bucket_bytes_total",
    "agg_launches",
)


def schema_dict(*, msg_bytes: float, packaged_bytes: float,
                wire_lowering: str, wire_bytes_per_worker: float,
                bucket_count: float, bucket_bytes_total: float,
                agg_launches: float) -> Dict[str, Union[float, str]]:
    """A fresh metrics dict: the byte fields are static per optimizer,
    the timing fields start at 0 and the step fills what it observes.
    ``bucket_count`` 0 means the per-leaf path; ``agg_launches`` is the
    aggregation's units a step (buckets, or leaves)."""
    return {
        "code_wait": 0.0,
        "iallgather_prepare_time": 0.0,
        "isend_time": 0.0,
        "comm_wait": 0.0,
        "decode_time": 0.0,
        "optim_step_time": 0.0,
        "msg_bytes": float(msg_bytes),
        "packaged_bytes": float(packaged_bytes),
        "wire_lowering": wire_lowering,
        "wire_bytes_per_worker": float(wire_bytes_per_worker),
        "bucket_count": float(bucket_count),
        "bucket_bytes_total": float(bucket_bytes_total),
        "agg_launches": float(agg_launches),
    }
