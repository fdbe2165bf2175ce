"""One module an optimizer of the port, as a traffic mix names it:
``build`` makes the port's optimizer the way a user does, and
``first_gradient`` reads, from its state after the first step, each
leaf's gradient as the optimizer received it."""
