from neuron_gan_tpu_torch.runtime.device import resolve_device  # noqa: F401
