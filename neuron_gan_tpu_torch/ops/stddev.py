"""The minibatch standard-deviation layer of Karras et al.'s critic
(progressive_growing_of_gans, networks.py::minibatch_stddev_layer), NCHW.

The batch splits into groups of ``G = min(group_size, N)`` samples as
``x.reshape(G, M, C, H, W)``: sample n belongs to group n mod M.  For each
group, the standard deviation over its G samples of every feature and
pixel (in float32, eps 1e-8 under the root), averaged over (C, H, W),
is one number, appended to each sample of the group as a constant
feature map.  Plain torch ops, so the WGAN-GP's gradient of a gradient
passes through it.

``calls_by_case`` counts calls by (G, x's shape), as the kernels' wrappers
count launches; a replayed CUDA graph passes no Python and counts none.
"""

import collections

import torch

calls_by_case = collections.Counter()


def minibatch_stddev(x, group_size=4, eps=1e-8):
    """x (N, C, H, W) -> (N, C + 1, H, W); N a multiple of min(group_size,
    N)."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    if n % g:
        raise ValueError(f'a batch of {n} does not split into groups of {g}')
    calls_by_case[g, tuple(x.shape)] += 1
    y = x.float().reshape(g, -1, c, h, w)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt((y * y).mean(dim=0) + eps)           # (M, C, H, W)
    y = y.mean(dim=(1, 2, 3)).to(x.dtype)               # (M,)
    y = y.reshape(1, -1, 1, 1, 1).expand(g, -1, 1, h, w).reshape(n, 1, h, w)
    return torch.cat([x, y], dim=1)
