"""The device's idle share of the traced segment, in %: 1 minus the
union of every device activity's interval over the segment's host-clock
length.  It reads ``device_idle.loop`` and ``device_idle.calls``."""


def read(trace, cell):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
