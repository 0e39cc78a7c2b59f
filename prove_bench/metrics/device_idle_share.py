"""device_idle_share: the share of the traced window in which no device
event ran: 1 - (the union of the events' intervals) / (the window's host
clock), in percent."""


def read(trace):
    if not trace.events:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
