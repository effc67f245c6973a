"""GroupNorm's share of the card's busy time: the device seconds of the
operations credited to the program's `groupnorm` spans (`spans.py`) over
the traced window's busy seconds, in percent.  The sampler runs no
backward, so this is all of GroupNorm's device time (the SiLU after it is
not inside the span)."""

import spans


def read(r):
    return spans.device_share(r, "groupnorm")
