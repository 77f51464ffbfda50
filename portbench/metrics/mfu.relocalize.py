"""The whole call's share of the card's f32 peak, %: the front end's and
encoder's operations of every traced call (counted from shapes) over the
traced window's length times 67 TFLOP/s. Registration's operations depend
on how many ICP iterations each pair runs, which nothing counts yet, so
they are left out: a lower bound."""
from portbench.counts.peaks import PEAK_F32_FLOPS


def read(ctx):
    return 100.0 * ctx.encode_flops * ctx.calls / (ctx.trace.window_s * PEAK_F32_FLOPS)
