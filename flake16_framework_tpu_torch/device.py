"""Device resolution for the port's entry points: one device, the device
list a config-batched sweep splits its configs over (the JAX package's
one-axis "config" mesh), or one process's share of the cards when the
batch spans processes (``rank_devices``)."""

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


def rank_devices(rank, world_size, per_rank, device_type="cuda"):
    """(the device list of rank ``rank`` of ``world_size`` processes, each
    driving ``per_rank`` devices; whether the ranks share one card). On
    the CPU a rank takes ``per_rank`` entries of ``cpu``. With at least
    ``world_size * per_rank`` visible CUDA devices the ranks take disjoint
    contiguous slices, rank-major; with fewer, every rank drives
    ``cuda:0`` alone (``shared_card`` true: the ranks share the card, or
    a single process drives one card where it asked for more), since one
    process may not list a card twice (``resolve_devices``)."""
    if not 0 <= rank < world_size or per_rank < 1:
        raise ValueError(f"rank {rank} of {world_size}, {per_rank} devices "
                         f"a rank")
    if resolve(device_type).type != "cuda":
        return resolve_devices([device_type] * per_rank), False
    if torch.cuda.device_count() >= world_size * per_rank:
        lo = rank * per_rank
        return resolve_devices([f"cuda:{i}" for i in range(
            lo, lo + per_rank)]), False
    return resolve_devices(["cuda:0"]), True
