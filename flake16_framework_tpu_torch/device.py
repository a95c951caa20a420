"""Device resolution for the port's entry points."""

import torch


def resolve(device=None):
    """The torch device an entry point runs on: ``cuda`` unless the caller
    asks for another. Raises when CUDA is asked for (or defaulted to) and
    missing; there is no silent CPU path. Also pins full-f32 matmuls and
    convolutions, as the JAX package pins ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
