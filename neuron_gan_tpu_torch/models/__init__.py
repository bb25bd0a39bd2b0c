from neuron_gan_tpu_torch.models.pggan import (  # noqa: F401
    DiscriminatorPG,
    GeneratorPG,
    GrowthState,
    PGConfig,
)
from neuron_gan_tpu_torch.models.karras import (  # noqa: F401
    DiscriminatorKarras,
    GeneratorKarras,
)
from neuron_gan_tpu_torch.runtime import precision_scope  # noqa: F401


def net_classes(cfg):
    """(G's class, D's class) of ``cfg.architecture``."""
    if cfg.architecture == 'karras':
        return GeneratorKarras, DiscriminatorKarras
    return GeneratorPG, DiscriminatorPG


def build_nets(cfg, rng, device=None):
    """(G, D) of ``cfg.architecture``, their weights drawn from ``rng``,
    G's first."""
    g_cls, d_cls = net_classes(cfg)
    return g_cls(cfg, rng, device=device), d_cls(cfg, rng, device=device)


def build_generator(cfg, rng, device=None):
    """G alone of ``cfg.architecture``."""
    return net_classes(cfg)[0](cfg, rng, device=device)
