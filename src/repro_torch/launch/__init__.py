"""The serving (:mod:`.serve`) and training (:mod:`.train`) launchers."""

from ..configs import get_config


def one_card_config(arch: str, smoke: bool, model: int = 1):
    """``arch``'s config as the launchers build it on one card, for a
    mesh whose model axis has ``model`` shards, as the JAX launchers'
    ``ep_degree=mesh.shape["model"]``: the published config's experts
    pad to a multiple of it (granite-moe-3b-a800m's 40 at 1, 2, 4 or 8,
    where the registry's default ``ep_degree=16`` pads to 48); a smoke
    config keeps its own, as the JAX registry's does."""
    return get_config(arch, smoke=smoke, ep_degree=model)
