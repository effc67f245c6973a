"""Attention's share of its roofline: the summed least time of the
attention work run in the traced window (frozen counts over the published
peaks, the larger of the operations and bytes bound a site; forward and
backward) over the device time spent in attention, in percent.
Attention's device time: the port's attention kernels by name, plus, per
unit, the kernels launched inside the autograd node of the flash sites'
gradient (autograd of the einsum path, `FlashAttention`'s backward), read
from the unit traced with host operations."""

import tracereader
import yardstick

# the port's kernels (ops/csrc): the packed forward, its dq and dk/dv
# backward, and the flash forward
KERNELS = r"(packed_attention|dq|dkdv|flash_attention)_kernel"
HOST_OPS = r"FlashAttentionBackward"


def read(r):
    if not r.attention:
        return None
    host = r.host_events()
    extra = (tracereader.device_seconds(host, KERNELS, HOST_OPS)
             - tracereader.device_seconds(host, KERNELS))
    seconds = tracereader.device_seconds(r.events, KERNELS) + r.units * extra
    return 100.0 * yardstick.least_seconds(r.attention) / seconds if seconds > 0 else None
