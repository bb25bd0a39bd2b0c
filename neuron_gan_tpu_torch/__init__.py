"""PyTorch/CUDA port of neuron_gan_tpu for NVIDIA Hopper.

Module names mirror the JAX package (``neuron_gan_tpu``) so each piece has
an obvious counterpart; the JAX package is the numerical reference and the
tests hold every module of this package against it on the same inputs.

Inside the port, activations are NCHW and conv weights OIHW (cuDNN's native
float32 layout); parameters cross to and from the JAX pytree format through
``convert.py``.  This package imports ``torch`` only -- never ``jax`` nor
anything of ``neuron_gan_tpu``.
"""
