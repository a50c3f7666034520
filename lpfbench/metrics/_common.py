"""Arithmetic the readers share."""


def idle_percent(view):
    """The traced window's share, in %, in which no kernel or copy ran
    on the device."""
    prof = view.profile
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)


def mean_span_ms(view):
    """The mean host time of the traced window's calls, from the call to
    its return, in ms."""
    spans = view.window.spans
    return 1e3 * sum(spans) / len(spans) if spans else None


def ms_per_unit(view):
    """The traced window's ms per unit of work."""
    prof, units = view.profile, view.window.units
    if prof is None or units == 0:
        return None
    return prof.window_s * 1e3 / units
