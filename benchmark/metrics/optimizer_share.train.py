"""Clip and Adam's share of the card's busy time: the device seconds of the
operations credited to the program's `optimizer` spans (`Optimizer.step`,
every optimizer of the step; `spans.py`) over the traced window's busy
seconds, in percent."""

import spans


def read(r):
    return spans.device_share(r, "optimizer")
