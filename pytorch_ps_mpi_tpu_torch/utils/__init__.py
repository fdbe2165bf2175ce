"""Helpers of the port: the metrics schema and its readers (``metrics``),
checkpoints (``checkpoint``) and JAX weight interop (``interop``)."""
