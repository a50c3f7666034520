"""The serving (:mod:`.serve`) and training (:mod:`.train`) launchers."""

from ..configs import get_config


def one_card_config(arch: str, smoke: bool):
    """``arch``'s config as the launchers build it on one card: a model
    axis of size 1, as the JAX launchers' ``ep_degree=mesh.shape["model"]``
    on one device, so no expert is padded (granite-moe-3b-a800m: 40
    experts, where the registry's default ``ep_degree=16`` pads to 48)."""
    return get_config(arch, smoke=smoke, ep_degree=1)
