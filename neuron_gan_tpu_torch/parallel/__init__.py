from neuron_gan_tpu_torch.parallel.data import (  # noqa: F401
    DataParallel, data_ranks, spawn, take_rows)
