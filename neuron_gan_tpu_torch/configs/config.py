"""Global configuration module (counterpart of
neuron_gan_tpu/configs/config.py).

Mirrors the reference config system (reference: configs/config.py:8-263):
module-level globals hold every knob; a user config ``.py`` is run with its
names validated against this module's registry; explicit CLI flags take
precedence over the user config, which takes precedence over the defaults
(reference: train.py:95-104).  ID-keyed architecture tables and the
validation asserts are the JAX package's, messages included.

The execution knobs at the bottom are the port's counterparts of the JAX
package's TPU knobs.  ``import_configs`` starts from the defaults every
time, so two runs in one process do not see each other's settings.
"""

import copy
import os
import uuid
from types import FunctionType, ModuleType

##################### Default configurations #####################
# Directories
root_dir = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))
configs_dir = os.path.dirname(__file__)
data_dir = os.path.join(root_dir, 'data')
images_dir = os.path.join(root_dir, 'images')
weights_dir = os.path.join(root_dir, 'weights')
plots_dir = os.path.join(root_dir, 'plots')
logs_dir = os.path.join(root_dir, 'logs')

# WGAN config (reference: configs/config.py:18-23)
wgan = False          # Use the fixed-resolution Wasserstein GAN model family
n_critic = 1          # Critic steps per generator step
adapt_critic = False  # Adapt the number of critic steps from the loss series
weights_init = ''     # Filename of initial G/D weights (.npz or reference .pth)
unroll_steps = 0      # Unrolled-GAN steps (accepted, unused — parity with reference train.py)

# PGGAN config (reference: configs/config.py:26-30)
pggan = True
grad_pen_lambda = 10          # Gradient-penalty weight
transit_sch = [25000, 50000, 75000, 100000, 125000]  # Epochs where transitions start
transit_period = None         # If set, overrides transit_sch with a fixed period
alpha_step = 0.0001           # Fade-in increment per epoch

# Training (reference: configs/config.py:33-49)
ID = uuid.uuid4().hex[:4]
samples_sub_dir = os.path.join(images_dir, '{}'.format(ID))
RMSprop = False
learning_rate = 0.0001
batch_size = 8
N_epochs = 150000
N_epochs_session = None      # Bound the number of epochs run in this session
beta1 = 0.5                  # Adam beta1 (beta2 fixed to 0.999, reference train.py:224)
sim_loss_lambda = 0.0
sim_loss_lambda_decay_rate = 0.0
drift_epsilon = 0.001
resume = False
N_workers = 2                # Accepted for CLI parity; the stack lives on the device
seed = 1
checkpointing_period = 100
device = 'default'           # 'cuda', 'cpu', or 'default' (= 'cuda'; never
                             # falls back to the CPU)
pin_memory = False           # Accepted for CLI parity; the stack is copied once

# Dataset (reference: configs/config.py:52-55)
dataset_name = 'science_2022'
dataset_dir = os.path.join(data_dir, dataset_name)
translation = 0.05
image_preprocessing = 'cpu'  # parity knob: 'cpu' = shuffled epochs (reference
                             # DataLoader default), 'device' = sequential order
                             # (reference DatasetIterator). Augmentation always
                             # runs on the device here either way.
dataset_preload_limit_mb = 100  # processed stacks above this build into an
                                # on-disk memmap cache instead of RAM
                                # (reference NeuronDataset.py:74-82 preloads
                                # only under 100 MB)

# Architecture (reference: configs/config.py:58-63)
latent_dim = 512
image_size = 512
N_colors = 1
LeakyReLU_leak = 0.2
N_gen_features = [128, 64, 32, 32, 16, 16]
N_dis_features = [16, 16, 32, 32, 64, 128]

# Execution on the GPU (the JAX package's TPU knobs, mapped)
mesh_shape = None            # e.g. {'data': 8} or {'data': 4, 'model': 2}; None
                             # = one process. D*M processes, one per card:
                             # 'data' splits each batch (parallel/data.py),
                             # 'model' shards the weights, Adam moments and
                             # EMA by output channel (parallel/mesh.py); a
                             # 'model' axis needs a 'data' axis beside it
compute_dtype = 'mixed'      # 'float32', 'bfloat16', or 'mixed' (bfloat16
                             # activations, float32 stem/norm statistics/
                             # images/critic head), as in the JAX package
matmul_precision = 'default' # 'default': float32 convs and matmuls may run
                             # in TF32 (PGConfig precision=None, the fused
                             # level boundaries on); 'highest': true float32
                             # (TF32 off).  The JAX package's 'high' (three
                             # bf16 passes) has no counterpart and is refused
use_kernels = True           # The hand-written CUDA kernels (LeakyReLU +
                             # PixelNorm pair, fused packed conv pair) in
                             # place of composed PyTorch ops; the port's
                             # counterpart of use_pallas / pallas_epilogue.
                             # On by the card's own numbers: the mixed step
                             # takes 69.3 ms of device time with them and
                             # 79.0 without (PERF.md §5, H100 80GB HBM3, 700 W)
packed_min_res = 64          # Space-to-depth packed conv threshold: layers at
                             # >= this resolution run 2x2-packed (ops/packed.py).
                             # None disables.
packed_lanes = 128           # The 16-channel packed levels in the 2x4 layout;
                             # None/64 keep the 2x2 layout
fast_augment = True          # Run the augmentation warp at phase resolution
                             # (the JAX package's fast path; quality-A/B'd
                             # there); False = the reference's exact order
shear_warp = 'auto'          # Augmentation warp: True = the shear rotation,
                             # False = the torchvision-exact gather warp,
                             # 'auto' = shear at every phase but 32^2
                             # (train_step.resolve_shear).  Needs fast_augment
gp_reuse_fakes = True        # Reuse the critic-loss fake batch for the
                             # gradient-penalty interpolates (the original
                             # WGAN-GP formulation, as the JAX package ships)
hbm_budget_mb = 4096         # Device-memory budget for the raw image stack.
                             # A stack above it stays on the host and
                             # streams to the device per epoch, two groups
                             # of batches in flight (streaming.py).  0
                             # keeps every stack on the device
ema_beta = 0.0               # EMA decay for a shadow generator (0 disables)
architecture = 'neuron'      # 'neuron': the neuron-gan PGGAN; 'karras': Karras
                             # et al.'s G_paper/D_paper (nearest upsampling,
                             # minibatch stddev, no PixelNorm in D; needs
                             # packed_min_res = None; configs/config_karras.py)
beta2 = 0.999                # Adam beta2 (Karras et al.: 0.99)
mirror_augment = False       # Augment by the horizontal flip alone (Karras
                             # et al.'s mirror_augment) in place of the warp
                             # and jitter
donate_state = True          # Accepted for parity; no effect: the port
                             # updates the models and optimizers in place
profile_dir = ''             # If set, capture a torch.profiler trace of one
                             # steady training chunk into this directory
swd_period = None            # Every N epochs, score 64 generated samples
                             # against the real set with multi-scale sliced
                             # Wasserstein distance (metrics.py) at the
                             # current native resolution, append to
                             # logs_dir/SWD_<ID>.jsonl and plot
                             # plots_dir/SWD_<ID>.png.  None follows
                             # checkpointing_period; 0 disables

################################### END OF CONFIGURATION VARIABLES ###################################


def _is_knob(name, value):
    """A module-level binding is a config knob iff it has a public name and a
    plain value (dunders, imported modules, and functions are machinery)."""
    return not (name.startswith('__')
                or isinstance(value, (ModuleType, FunctionType)))


# Snapshot of every knob name -> default value, taken before the machinery
# below is defined: the whitelist user configs and CLI overrides are
# validated against, and the defaults each import starts from.
configs_name = {n: v for n, v in list(globals().items()) if _is_knob(n, v)}

# the matmul_precision values the port takes -> PGConfig.precision
PRECISIONS = {'default': None, 'highest': 'highest'}


def reset_configs():
    """Every knob back to its default."""
    globals().update(copy.deepcopy(configs_name))


def precision_of(matmul_precision):
    """PGConfig.precision for a ``matmul_precision`` value."""
    if matmul_precision not in PRECISIONS:
        raise ValueError(
            f'matmul_precision={matmul_precision!r} is not supported by the '
            f"port: use 'default' (TF32 allowed) or 'highest' (true float32)")
    return PRECISIONS[matmul_precision]


def define_ID_dependent_configs():
    """ID-keyed architecture lookup (reference: configs/config.py:84-109)."""
    global ID, N_gen_features, N_dis_features, samples_sub_dir
    assert ID != '', 'ID is not defined.'
    if ID in ['0004', '0005']:
        N_gen_features = [1024, 512, 256, 128, 64, 32, 16, 8]
        N_dis_features = [16, 32, 64, 128, 128, 128, 128]
    elif ID in ['0006']:
        N_gen_features = [512, 256, 128, 64, 32, 16, 8, 8]
        N_dis_features = [64, 128, 256, 256, 256, 128, 64]
    elif ID in ['0007']:
        N_gen_features = [512, 256, 128, 64, 32, 16]
        N_dis_features = [16, 32, 64, 128, 256, 512]
    elif ID in ['0008']:
        N_gen_features = [512, 256, 128, 64]
        N_dis_features = [64, 128, 256, 512]
    elif ID in ['0009']:
        N_gen_features = [32, 32, 32, 32, 16, 16]
        N_dis_features = [16, 16, 32, 32, 32, 32]
    elif ID in [str(i).rjust(4, '0') for i in range(10, 13)]:
        N_gen_features = [128, 64, 32, 32, 16, 16]
        N_dis_features = [16, 16, 32, 32, 64, 128]
    samples_sub_dir = os.path.join(images_dir, '{}'.format(ID))


def print_configs():
    print('Configurations:')
    # this module's own namespace, also after a caller dropped the module
    # from sys.modules for a fresh import
    for name in configs_name:
        print(f'{name}:', globals()[name])


def validate_configs(interactive=True):
    """Validation asserts + directory creation (reference: configs/config.py:120-200),
    then the port's refusals of what it does not run."""
    global device, dataset_dir, images_dir, samples_sub_dir, weights_dir, plots_dir
    dataset_dir = os.path.abspath(dataset_dir)
    images_dir = os.path.abspath(images_dir)
    samples_sub_dir = os.path.abspath(samples_sub_dir)
    weights_dir = os.path.abspath(weights_dir)
    plots_dir = os.path.abspath(plots_dir)

    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(weights_dir, exist_ok=True)
    os.makedirs(plots_dir, exist_ok=True)
    os.makedirs(logs_dir, exist_ok=True)

    # Samples sub-directory collision prompt (reference: configs/config.py:136-146)
    from neuron_gan_tpu_torch.utils.io import validated_input
    import shutil
    if os.path.exists(samples_sub_dir) and not resume:
        if interactive:
            prompt = ('Samples directory already exists.\nSamples directory:{}\n'
                      'Erase and create a new directory(y/n)?'.format(samples_sub_dir))
            ans = validated_input(prompt, lambda x: x in ['y', 'n'], default='n')
            if ans == 'y':
                shutil.rmtree(samples_sub_dir)
                os.makedirs(samples_sub_dir, exist_ok=True)
    elif not os.path.exists(samples_sub_dir):
        os.makedirs(samples_sub_dir, exist_ok=True)

    # 'default' is the card: the port never falls back to the CPU
    if device == 'default':
        device = 'cuda'

    import math
    image_size_log = round(math.log2(image_size))
    assert image_size == 2 ** image_size_log, 'Image size must be a power of 2.'
    assert ID != '', 'The training ID is undefined.'
    assert compute_dtype in ('float32', 'bfloat16', 'mixed'), f'compute_dtype:{compute_dtype} is not supported.'
    assert hbm_budget_mb >= 0, 'hbm_budget_mb must be >= 0 (0 disables streaming).'
    assert shear_warp in (True, False, 'auto'), \
        f'shear_warp must be True, False or "auto"; got {shear_warp!r}.'
    assert packed_lanes in (None, 64, 128), \
        f'packed_lanes must be None, 64 or 128; got {packed_lanes!r}.'
    assert architecture in ('neuron', 'karras'), \
        f"architecture must be 'neuron' or 'karras'; got {architecture!r}."
    assert architecture != 'karras' or packed_min_res is None, \
        "architecture 'karras' takes no packed layout: set packed_min_res = None."
    global swd_period
    if swd_period is None:  # auto: quality curve at checkpoint cadence
        swd_period = checkpointing_period
    assert swd_period >= 0, 'swd_period must be >= 0 (0 disables).'

    if pggan:
        global transit_sch, transit_period
        err_msg = 'The number of layers in the generator and discriminator must match.'
        assert len(N_gen_features) == len(N_dis_features), err_msg

        N_upsamples = len(N_gen_features) - 1
        image_size_initial = image_size // (2 ** N_upsamples)
        assert image_size_initial >= 4, 'The initial image size must be >= 4. Reduce the number of layers'

        if transit_period is not None:
            transit_sch = [i * transit_period for i in range(1, N_upsamples + 1)]

        err_msg = ('The number of transitions ({}) does not match the number of '
                   'convolution layers ({})'.format(len(transit_sch), N_upsamples))
        assert N_upsamples == len(transit_sch), err_msg
        assert N_epochs > transit_sch[-1], \
            'The number of epochs must be greater than the last resolution transition'

        N_transition_epochs = math.ceil(1 / alpha_step)
        diffs = [b - a for a, b in zip(transit_sch, transit_sch[1:])]
        err_msg = 'The transitions must be separated by at least {} epochs'.format(N_transition_epochs)
        assert all(d > N_transition_epochs for d in diffs), err_msg

    # what the port does not run, refused by name
    precision_of(matmul_precision)
    from neuron_gan_tpu_torch.parallel.mesh import mesh_ranks
    mesh_ranks(mesh_shape)


define_ID_dependent_configs()


def _resolve_config_path(filename):
    """Normalize a user-config filename to an existing .py path.

    Relative names are searched in the package configs dir first, then in the
    caller's ./configs, so user projects can keep configs outside the
    installed package.
    """
    stem, ext = os.path.splitext(filename)
    if ext not in ('', '.py'):
        raise ValueError('Filename must be a .py file')
    filename = stem + '.py'
    if os.path.isabs(filename):
        candidates = [filename]
    else:
        candidates = [os.path.join(configs_dir, filename),
                      os.path.join(os.getcwd(), 'configs', filename)]
    for path in candidates:
        if os.path.exists(path):
            return path
    raise AssertionError(
        f'The configuration file {filename} does not exist in {configs_dir}')


def import_configs(filename, overwritten_configs=None, interactive=True):
    """Run a user config .py, validate its names, merge CLI overrides.

    Precedence: defaults < user config module < overwritten_configs
    (reference contract: configs/config.py:208-263; train.py:95-104).
    """
    overrides = dict(overwritten_configs or {})
    for name in overrides:
        if name not in configs_name:
            raise ValueError(f"The overwritten config '{name}' is not defined.")

    path = _resolve_config_path(filename)

    # Execute the user file in its own namespace and keep only knob bindings.
    import runpy
    user_ns = runpy.run_path(path)
    user_knobs = {}
    for name, value in user_ns.items():
        if not _is_knob(name, value):
            continue
        if name not in configs_name:
            raise ValueError(f"The imported config '{name}' is not defined.")
        user_knobs[name] = value

    user_knobs.update(overrides)  # explicit CLI flags win
    reset_configs()
    globals().update(user_knobs)

    # (samples_sub_dir is derived inside define_ID_dependent_configs)
    define_ID_dependent_configs()
    validate_configs(interactive=interactive)


if __name__ == '__main__':
    import_configs('config_ex.py')
    print_configs()
