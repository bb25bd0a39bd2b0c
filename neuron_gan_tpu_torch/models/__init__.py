from neuron_gan_tpu_torch.models.pggan import (  # noqa: F401
    DiscriminatorPG,
    GeneratorPG,
    GrowthState,
    PGConfig,
    precision_scope,
)
