"""Error feedback: after the first step (its memory started at zero) the
memory holds what the inner codec left out, so the gradient is what the
optimizer received (one worker's decode) plus the memory."""


def raw_first_gradient(opt, received):
    return {k: g + opt.codec_state[k]["memory"].float()
            for k, g in received.items()}
