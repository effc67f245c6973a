"""The DiT's adaLN chain's share of the card's busy time: the device
seconds of the operations credited to the program's `dit.modulate` spans
(`spans.py`: each LayerNorm with its shift and scale, each gated residual
add, the final layer's modulate) over the traced window's busy seconds, in
percent.  A program without the span reads 0 where it records spans, None
where it records none."""

import spans


def read(r):
    return spans.device_share(r, "dit.modulate")
