from neuron_gan_tpu_torch.models.pggan import (  # noqa: F401
    DiscriminatorPG,
    GeneratorPG,
    GrowthState,
    PGConfig,
)
from neuron_gan_tpu_torch.runtime import precision_scope  # noqa: F401
