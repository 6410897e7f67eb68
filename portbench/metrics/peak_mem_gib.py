"""peak_mem_gib (device): ``torch.cuda.max_memory_allocated()`` over the
window, after ``reset_peak_memory_stats()`` at its start; the largest
rank's on the pod cell."""


def read(r):
    return r.window_peak_bytes / 2**30 if r.window_peak_bytes else None
