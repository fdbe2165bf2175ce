"""Plain PyTorch references the benchmark holds the port against.

Every module here imports ``torch`` (and the standard library) only: no
module of the port, no JAX. They compute in float32 with TF32 off
(:func:`precision.highest`), or, for the control, with every product
in a lower precision (:mod:`.precision`).
"""
