"""One module a model family: how the benchmark builds the port's model
from a configuration file, makes its weights and batches from the seed,
runs the plain reference, and counts a step's model FLOPs.

Every family module has the same functions: ``program_model``,
``program_loss``, ``weights``, ``pool``, ``samples``, ``half``,
``reference_loss_and_grads`` and ``step_flops``, and ``HEAD``: the
leaves whose gradient reaches them through no ReLU, max-pool or other
piecewise derivative.
"""
