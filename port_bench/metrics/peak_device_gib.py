"""The card's peak allocated memory over the run up to the window's end,
set-up included (``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    peak = ctx["record"]["peak_bytes"]
    return peak / 2 ** 30 if peak else None
