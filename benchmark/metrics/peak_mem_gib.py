"""torch.cuda.max_memory_allocated over the run, before the reference, GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
