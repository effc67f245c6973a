"""Share of the traced window in which no operation ran on the card:
1 - (union of kernel, copy and set intervals) / window, in percent."""


def read(r):
    return 100.0 * (1.0 - r.summary.busy_s / r.summary.window_s)
