"""``step_host_ms`` (ms): the host time of one training step, from the
call into the step to its return (the mean over the traced window's
steps)."""
from lpfbench.metrics._common import mean_span_ms


def read(view):
    return mean_span_ms(view)
