"""Attention's share of its roofline: the summed least time of the
attention work run in the traced window (frozen counts over the published
peaks, the larger of the operations and bytes bound a site) over the
device time of the port's attention kernels there, in percent.  The
sampler runs no backward."""

import tracereader
import yardstick

# the port's kernels (ops/csrc): the packed forward and the flash forward
KERNELS = r"(packed_attention|flash_attention)_kernel"


def read(r):
    if not r.attention:
        return None
    seconds = tracereader.device_seconds(r.events, KERNELS)
    return 100.0 * yardstick.least_seconds(r.attention) / seconds if seconds > 0 else None
