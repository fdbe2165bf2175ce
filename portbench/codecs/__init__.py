"""One module a codec of the port, as a traffic mix names it:
``raw_first_gradient(opt, received)`` works out, from the optimizer's
state after the first step, each leaf's gradient before the codec (None
where the codec's state cannot give it back). ``received`` is the
gradient as the optimizer received it (``optimizers/<name>.py``)."""
