"""device_idle_share (%): the share of the traced jobs' wall time in which
no kernel, copy or set ran on the card, from the profiler's device
timeline.  Layer: the device.  Moves updates_per_s."""


def read(tl):
    if not tl.device or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
