"""Device resolution for the port's entry points: one device, or the
device list a config-batched sweep splits its configs over (the JAX
package's one-axis "config" mesh)."""

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


def default_devices():
    """Every visible CUDA device, indexed, as the JAX package's
    ``default_mesh`` takes every local device. Raises without CUDA, as
    ``resolve`` does."""
    resolve("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_devices(devices=None):
    """The device list of a config-batched sweep: ``default_devices()``
    when None, else each entry through ``resolve``. CUDA entries are
    indexed (plain ``cuda`` is the current device), must exist and must be
    distinct: one worker a card. A list that repeats ``cpu`` is the CPU's
    stand-in for several cards (the JAX tests' virtual devices); a list
    that mixes device types raises."""
    if devices is None:
        return default_devices()
    devs = [resolve(d) for d in devices]
    if not devs:
        raise ValueError("the device list is empty")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"the device list mixes {sorted(kinds)}")
    if devs[0].type != "cuda":
        return devs
    devs = [torch.device("cuda", torch.cuda.current_device()
                         if d.index is None else d.index) for d in devs]
    for d in devs:
        if d.index >= torch.cuda.device_count():
            raise ValueError(f"{d} is not a visible CUDA device")
    if len(set(devs)) != len(devs):
        raise ValueError(f"a CUDA device is listed twice: {devs}")
    return devs
