"""Kernels the card ran in the traced window over the train steps run in it."""


def read(r):
    return r.summary.kernels / r.steps if r.steps else None
