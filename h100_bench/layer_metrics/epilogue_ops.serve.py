"""Device operations a batch that the port's forward launches outside
its convolutions (bias adds, activation passes, casts, residual adds,
concatenations, pools, pads, upsamples) in the traced window: the
kernels, copies and sets the trace links to the host ops under one of
the port's ``mc.serve.forward`` ranges, less those of the ``aten`` conv
ops and what they call (``drivers/stream_heads.forward_launches``); the
median over the window's ranges. A fused conv epilogue would cut it. A
run whose driver does not count them (``stream``'s) reads as nothing."""

import statistics


def read(run):
    counted = run.get("forward_launches") if run.get("trace") else None
    if not counted:
        return None
    return statistics.median(total - conv for total, conv in counted)
