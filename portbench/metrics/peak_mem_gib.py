"""``torch.cuda.max_memory_allocated()`` over the run up to the window's
close, set-up included, in GiB."""


def read(rec):
    peak = rec.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
