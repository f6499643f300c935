"""peak_gib (GiB, lower, end to end): ``torch.cuda.max_memory_allocated()``
over the window, weights included, after ``reset_peak_memory_stats()`` at
its start: the card a user needs."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
