from neuron_gan_tpu_torch.runtime.device import (  # noqa: F401
    precision_scope, resolve_device)
