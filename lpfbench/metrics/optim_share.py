"""``optim_share`` (%): the device time of the optimizer, the ops inside
the ``train.optimizer`` spans (``runtime/train_step.py`` around
``adamw_update``), over the device's busy time."""
from lpfbench.metrics._spans import span_share


def read(view):
    return span_share(view, "train.optimizer")
