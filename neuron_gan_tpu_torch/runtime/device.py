"""Device resolution and float32 precision, shared by every entry point of
the port."""

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Without CUDA that is an error, never a silent
    fall back to the CPU: a caller that wants the CPU asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the port '
                'on the CPU')
        return torch.device('cuda')
    return torch.device(device)


@contextlib.contextmanager
def precision_scope(precision):
    """Run a block with TF32 off (``'highest'``) or allowed (``None``) for
    cuDNN convolutions and cuBLAS matmuls, restoring both flags after.
    cuDNN's float32 convs default to TF32, which would break parity with
    the JAX package's 'highest' precision."""
    allow = precision is None
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
