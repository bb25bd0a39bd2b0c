"""Device resolution shared by every entry point of the port."""

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
