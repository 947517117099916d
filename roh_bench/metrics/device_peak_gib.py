"""torch.cuda.max_memory_allocated over the window (reset after the
set-up), in GiB."""


def read(w):
    return w.peak_bytes / 2 ** 30 if w.peak_bytes > 0 else None
