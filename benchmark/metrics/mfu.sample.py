"""The whole step's share of the card's peak: the frozen model FLOPs of
the units run in the traced window (matrix products and convolutions,
forward only: UNet calls and the decode) over the window's seconds and the bf16
tensor-core peak, in percent."""

import yardstick


def read(r):
    if not r.flops:
        return None
    return 100.0 * r.flops / r.summary.window_s / yardstick.PEAK_BF16_FLOPS
