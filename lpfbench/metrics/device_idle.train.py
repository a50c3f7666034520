"""``device_idle.train`` (%): the traced window's share with no kernel
running on the device, in the training cells."""
from lpfbench.metrics._common import idle_percent


def read(view):
    return idle_percent(view)
