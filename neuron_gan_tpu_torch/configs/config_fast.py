"""Maximum-throughput training preset: config_ex plus every speed knob of
the port pinned explicitly (the port's copy of the JAX package's
config_fast.py, with the port's knob names).

Every knob this preset sets is also the port's default: the JAX package's
shipping step, which its SWD quality A/Bs promoted ('mixed' compute,
TF32 allowed with the fused level boundaries, the packed layouts with the
2x4 one at 16 channels, the fast augmentation with the shear warp, the
gradient penalty on the critic-loss fake batch), with the CUDA kernels on.
The preset keeps that set pinned should a default change.  Which of them
is faster on the H100 is measured in PERF.md, not assumed from the TPU.

    python -m neuron_gan_tpu_torch.train --configs config_fast
"""

import os

# Directories
root_dir = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))
data_dir = os.path.join(root_dir, 'data')
images_dir = os.path.join(root_dir, 'images')
weights_dir = os.path.join(root_dir, 'weights')
plots_dir = os.path.join(root_dir, 'plots')

# WGAN config
wgan = False
n_critic = 1
adapt_critic = False
weights_init = ''
unroll_steps = 0

# PGGAN config
pggan = True
grad_pen_lambda = 10
transit_sch = [25000, 50000, 75000, 100000, 125000]
transit_period = None
alpha_step = 0.0001

# Training
ID = ''
samples_sub_dir = os.path.join(images_dir, '{}'.format(ID))
RMSprop = False
learning_rate = 0.0001
batch_size = 8
N_epochs = 150000
beta1 = 0.5
sim_loss_lambda = 0.0
sim_loss_lambda_decay_rate = 0.0
drift_epsilon = 0.001
resume = True
N_workers = 0
seed = 1
checkpointing_period = 100
device = 'default'
pin_memory = False

# Dataset
dataset_name = 'science_2022'
dataset_dir = os.path.join(data_dir, dataset_name)
translation = 0.05

# Architecture
latent_dim = 64
image_size = 512
N_colors = 1
LeakyReLU_leak = 0.2
N_gen_features = [128, 64, 32, 32, 16, 16]
N_dis_features = [16, 16, 32, 32, 64, 128]

# Speed/quality trade knobs (see module docstring; all are the defaults)
compute_dtype = 'mixed'
matmul_precision = 'default'
use_kernels = True
packed_min_res = 64
packed_lanes = 128
fast_augment = True
shear_warp = True
gp_reuse_fakes = True
