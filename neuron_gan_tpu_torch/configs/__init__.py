from neuron_gan_tpu_torch.configs import config  # noqa: F401
