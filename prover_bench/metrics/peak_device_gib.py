"""peak_device_gib: `torch.cuda.max_memory_allocated` over the window,
reset when it opens, in GiB."""


def read(run):
    return run.peak_bytes / (1 << 30) if run.peak_bytes else None
