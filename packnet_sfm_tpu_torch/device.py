"""Device choice for the PyTorch port: the card unless the caller asks for
the CPU, and never a silent fall back from one to the other."""

import torch


def resolve_device(device=None):
    """Return `torch.device('cuda')` for None/'cuda', and the CPU only when
    asked for by name. Raises when CUDA is requested but absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA was requested but torch.cuda.is_available() is False; '
                "pass device='cpu' to run on the CPU")
        return dev
    if dev.type == 'cpu':
        return dev
    raise ValueError('unsupported device {!r}'.format(device))
