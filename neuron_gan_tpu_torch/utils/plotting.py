"""Sample grids and training plots (counterpart of
neuron_gan_tpu/utils/plotting.py).

``save_image_grid`` replicates torchvision.utils.save_image semantics
(reference utils.py:602-610): tile into a grid with 2px padding, min-max
normalize over the whole batch when ``normalize=True``, then
``mul(255).add(0.5).clamp`` and write a PNG (PIL where it imports, else
the port's PNG writer).

``gen_samples``/``plot_gen_samples`` mirror reference utils.py:346-355 and
:568-610: seeded hypersphere latents (identical across checkpoints), a
no-grad generator forward, nearest-upsample to image_size_max mid-growth.
The latents come from a CPU torch.Generator seeded with ``seed`` (the same
on every device), or are given (``z``): they never match the JAX
package's, whose stream differs.

The curve plots need matplotlib; where it does not import, each says once
that it is skipped and why.  Nothing on the training path depends on them.
"""

import os

import numpy as np
import torch

from neuron_gan_tpu_torch.ops.resize import resize_nearest
from neuron_gan_tpu_torch.runtime import precision_scope
from neuron_gan_tpu_torch.utils.latents import sample_latent_vec
from neuron_gan_tpu_torch.utils.png import write_png

_skipped = set()


def pyplot_or_skip(what):
    """matplotlib.pyplot on the Agg backend, or None (said once per plot)
    where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        if what not in _skipped:
            _skipped.add(what)
            print(f'{what} plot skipped: matplotlib is not installed')
        return None
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def make_grid(images_nhwc, nrow=8, padding=2, pad_value=0.0, normalize=False):
    """images: (N, H, W, C) -> (GH, GW, C) float grid."""
    imgs = np.asarray(images_nhwc, dtype=np.float32)
    if normalize:
        lo, hi = imgs.min(), imgs.max()
        if hi - lo > 1e-12:
            imgs = (imgs - lo) / (hi - lo)
        else:
            imgs = np.zeros_like(imgs)
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = int(np.ceil(n / ncol))
    gh = nrows * (h + padding) + padding
    gw = ncol * (w + padding) + padding
    grid = np.full((gh, gw, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = imgs[i]
    return grid


def save_image_grid(images_nhwc, filename, nrow=8, normalize=True):
    grid = make_grid(images_nhwc, nrow=nrow, normalize=normalize)
    arr = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        write_png(filename, arr)
        return
    if arr.shape[-1] == 1:
        Image.fromarray(arr[..., 0]).save(filename)
    else:
        Image.fromarray(arr).save(filename)


def seeded_latents(n_images, latent_dim, seed):
    """The latents of ``seed``: drawn on the CPU, so every device sees the
    same ones."""
    return sample_latent_vec(torch.Generator().manual_seed(int(seed)),
                             (n_images, latent_dim))


def gen_samples(g, growth, n_images=16, seed=None, z=None):
    """Latents (seeded, or the caller's ``z``) -> the generator ``g`` at
    ``growth``'s phase and alpha, without gradients.  Returns
    (images NCHW, z), both on ``g``'s device."""
    cfg = g.cfg
    device = next(g.parameters()).device
    if z is None:
        z = seeded_latents(n_images, cfg.latent_dim,
                           0 if seed is None else seed)
    z = torch.as_tensor(z, dtype=torch.float32).to(device)
    alpha = growth.alpha if growth.fading else None
    with torch.no_grad(), precision_scope(cfg.precision):
        images = g(z, growth.phase, alpha)
    return images.float(), z


def plot_gen_samples(g, growth, n_images=16, seed=None, filename=None,
                     eval_noise=None):
    """Sample a grid and save it to ``filename``.  Returns the images as a
    float32 numpy (N, H, W, C) array at image_size_max."""
    images, _ = gen_samples(g, growth, n_images, seed=seed, z=eval_noise)
    n_images = images.shape[0]
    # Upsample mid-growth samples to the final resolution (nearest — the
    # reference uses F.interpolate's default mode, utils.py:598-600).
    if images.shape[-1] != g.cfg.image_size_max:
        images = resize_nearest(images, g.cfg.image_size_max)
    images = images.permute(0, 2, 3, 1).cpu().numpy()
    n_rows = int(np.round(np.sqrt(n_images)))
    if filename is not None:
        save_image_grid(images, filename, nrow=n_rows, normalize=True)
    return images


def plot_scores(loss_real, loss_fake, filename, g_loss=None, d_loss=None):
    """Score curves PNG (reference utils.py:649-665)."""
    plt = pyplot_or_skip('score')
    if plt is None:
        return
    fig = plt.figure()
    plt.plot(loss_real, label='Real images (<D(x)>_x)')
    plt.plot(loss_fake, label='Fake images (<D(G(z))>_z)')
    if g_loss is not None and len(g_loss):
        plt.plot(g_loss, label='Generator')
    if d_loss is not None and len(d_loss):
        plt.plot(d_loss, label='Discriminator')
    plt.legend(loc='upper left')
    plt.xlabel('Epoch')
    plt.savefig(filename)
    plt.close(fig)


def plot_swd(records, filename):
    """Sample-quality curve PNG from SWD monitor records (``epoch``,
    ``swd_mean``, ``levels`` finest first, ``resolution``); growth
    transitions are marked, SWD values compare only within one
    resolution."""
    if not records:
        return
    plt = pyplot_or_skip('SWD')
    if plt is None:
        return
    epochs = [r['epoch'] for r in records]
    fig = plt.figure()
    plt.plot(epochs, [r['swd_mean'] for r in records], marker='o',
             label='SWD mean (all bands)')
    plt.plot(epochs, [r['levels'][0] for r in records], marker='.',
             label='SWD finest band')
    prev_res = None
    for r in records:
        if prev_res is not None and r['resolution'] != prev_res:
            plt.axvline(r['epoch'], color='gray', ls=':', lw=0.8)
        prev_res = r['resolution']
    plt.legend(loc='upper right')
    plt.xlabel('Epoch')
    plt.ylabel('Sliced Wasserstein distance (lower is better)')
    plt.savefig(filename)
    plt.close(fig)


def calculate_grad_norm_hist(grads, grad_min=-30, log_scale=True):
    """|grad| values flattened (+log10), with mean/std (reference
    utils.py:249-275); ``grads`` is a list of tensors or arrays."""
    leaves = [np.abs(np.asarray(torch.as_tensor(g).detach().cpu().float())).ravel()
              for g in grads]
    vals = np.concatenate(leaves) if leaves else np.array([])
    if log_scale:
        vals = np.log10(np.maximum(vals, 10.0 ** grad_min))
    else:
        vals = np.maximum(vals, grad_min)
    if vals.size:
        return vals, float(vals.mean()), float(vals.std())
    return vals, float('nan'), float('nan')


def plot_grad_norm(gen_grads, dis_grads, filename=None):
    """Histograms of log10 |grad| for both nets (reference utils.py:619-645)."""
    plt = pyplot_or_skip('gradient-norm')
    if plt is None:
        return
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 5))
    gvals, gmean, gstd = calculate_grad_norm_hist(gen_grads)
    ax1.hist(gvals, alpha=0.75)
    ax1.set_title('Generator, $\\mu$={:.2}, $\\sigma$={:.2}'.format(gmean, gstd))
    ax1.set_xlabel('Parameter gradient norm (Logged)')
    ax1.set_ylabel('Counts')
    dvals, dmean, dstd = calculate_grad_norm_hist(dis_grads)
    ax2.hist(dvals, alpha=0.75)
    ax2.set_title('Discriminator, $\\mu$={:.2}, $\\sigma$={:.2}'.format(dmean, dstd))
    ax2.set_xlabel('Parameter gradient norm (Logged)')
    ax2.set_ylabel('Counts')
    fig.tight_layout()
    if filename is None:
        fig.show()
    else:
        fig.savefig(filename)
        plt.close(fig)


def n_params(tree):
    """The number of parameters of an nn.Module, or of a nested dict/list
    of arrays (a JAX-layout parameter tree)."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(n_params(v) for v in tree)
    return int(np.prod(np.shape(tree)))


def plot_dataset(dataset, resolutions, filename_prefix='Dataset',
                 directory=None, augment=False, seed=0):
    """Save the dataset grid at several resolutions (reference
    data/NeuronDataset.py:209-220): crop, renormalisation, the augmentation
    when ``augment`` (its draws from a CPU generator seeded with ``seed``),
    resize to each resolution, nearest-upsampled back to the largest size
    for tiles of one size.  Returns the files written."""
    from neuron_gan_tpu_torch.data.augment import (
        AugmentSpec, augment_batch, draw_augment)
    if directory is None:
        from neuron_gan_tpu_torch.configs import config
        directory = config.images_dir
    os.makedirs(directory, exist_ok=True)
    size_max = dataset.image_size_max
    stack = torch.from_numpy(np.asarray(dataset.images))
    out_files = []
    for res in resolutions:
        spec = AugmentSpec(crop_size=size_max, out_size=int(res),
                           translation=dataset.im_translation, augment=augment)
        draws = draw_augment(torch.Generator().manual_seed(seed), len(stack),
                             stack.shape[1], spec)
        with precision_scope('highest'):
            images = augment_batch(stack, draws, spec)
        if images.shape[-1] != size_max:
            images = resize_nearest(images, size_max)
        path = os.path.join(directory,
                            '{}_{}x{}.png'.format(filename_prefix, res, res))
        save_image_grid(images.permute(0, 2, 3, 1).numpy(), path, nrow=4,
                        normalize=True)
        out_files.append(path)
    return out_files


def plot_image(image_hwc):
    """Show one image with a colorbar (reference utils.py:550-554)."""
    plt = pyplot_or_skip('image')
    if plt is None:
        return
    plt.clf()
    arr = np.asarray(image_hwc)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    plt.imshow(arr, cmap='gray')
    plt.colorbar()


def plot_sample(dataset, ind=None):
    """Show a random (augment-free) dataset sample (reference
    utils.py:558-564)."""
    n = len(dataset)
    if ind is None:
        ind = int(np.random.randint(0, n))
    elif ind > n - 1:
        raise ValueError('ind must be smaller than {}'.format(n))
    plot_image(dataset.images[ind])
