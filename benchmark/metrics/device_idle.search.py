"""The device's idle share over a few profiled steady steps of the window:
1 - the union of its activity intervals over the traced window (%); none
where the profiler saw no device activity."""


def read(rec):
    t = rec.window.trace
    share = None if t is None else t.idle_share()
    return None if share is None else 100.0 * share
