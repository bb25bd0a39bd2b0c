"""Example user config: every knob a user config may set, with the values the
reference ships (reference: configs/config_ex.py:12-54); a copy of the JAX
package's config_ex.py.  Copy and edit."""

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
