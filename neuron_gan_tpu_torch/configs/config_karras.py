"""Karras et al.'s PGGAN at CelebA-HQ 1024^2 (ICLR 2018, arXiv:1710.10196;
github.com/tkarras/progressive_growing_of_gans, networks.py G_paper and
D_paper, loss.py D_wgangp_acgan and G_wgan_acgan, config.py), run by the
port's train CLI:

    python -m neuron_gan_tpu_torch.train --configs config_karras

Nine levels, 4^2 to 1024^2, widths nf(stage) = min(8192 / 2^stage, 512);
latent 512, pixel-normalised; RGB; WGAN-GP (lambda 10, target 1) with the
drift 0.001 D(x)^2; Adam lr 0.001, beta1 0, beta2 0.99, eps 1e-8; G's EMA
at 0.999; the horizontal flip as the only augmentation.  What differs from
the paper's run: one batch size at every level (4, the 1024^2 level's per
GPU; the paper's minibatch shrinks with resolution), the port's epoch
schedule (600k images a stable and a fading stretch are 20 epochs of the
30,000 CelebA-HQ images; the port's lr decays within each level, the
paper's is constant), and the port's shipping precision ('mixed', TF32
allowed) in place of float32.  The dataset directory holds the images as
files (the paper reads TFRecords).
"""

import os

# Directories
root_dir = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))
data_dir = os.path.join(root_dir, 'data')
images_dir = os.path.join(root_dir, 'images')
weights_dir = os.path.join(root_dir, 'weights')
plots_dir = os.path.join(root_dir, 'plots')

# PGGAN config
pggan = True
grad_pen_lambda = 10
transit_sch = [20, 60, 100, 140, 180, 220, 260, 300]
alpha_step = 0.05

# Training
ID = ''
samples_sub_dir = os.path.join(images_dir, '{}'.format(ID))
learning_rate = 0.001
batch_size = 4
N_epochs = 400
beta1 = 0.0
beta2 = 0.99
drift_epsilon = 0.001
ema_beta = 0.999
seed = 1
checkpointing_period = 20

# Dataset
dataset_name = 'celeba_hq_1024'
dataset_dir = os.path.join(data_dir, dataset_name)
translation = 0.0
mirror_augment = True

# Architecture
architecture = 'karras'
latent_dim = 512
image_size = 1024
N_colors = 3
LeakyReLU_leak = 0.2
N_gen_features = [512, 512, 512, 512, 256, 128, 64, 32, 16]
N_dis_features = [16, 32, 64, 128, 256, 512, 512, 512, 512]

# Execution: the shipping precision; no packed layout (it builds in the
# neuron variant's bilinear upsampling and pool-first critic)
compute_dtype = 'mixed'
matmul_precision = 'default'
use_kernels = True
packed_min_res = None
packed_lanes = None
gp_reuse_fakes = True
