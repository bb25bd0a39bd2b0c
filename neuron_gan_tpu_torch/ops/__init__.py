from neuron_gan_tpu_torch.ops.equalized import (  # noqa: F401
    calculate_gain,
    conv2d,
    equalized_conv2d,
    equalized_linear,
    init_conv2d,
    init_linear,
)
from neuron_gan_tpu_torch.ops.fadein import fade_in  # noqa: F401
# (the composed lrelu_pixel_norm stays in ops.pixelnorm: the name
# ops.lrelu_pixel_norm is the fused kernel's module)
from neuron_gan_tpu_torch.ops.pixelnorm import leaky_relu, pixel_norm  # noqa: F401
from neuron_gan_tpu_torch.ops.resize import (  # noqa: F401
    avg_pool,
    downsample2_bilinear,
    resize_antialias,
    resize_nearest,
    upsample2_bilinear,
    upsample2_nearest,
)
from neuron_gan_tpu_torch.ops.stddev import minibatch_stddev  # noqa: F401
