"""device_mem_peak_GiB (GiB): torch.cuda.max_memory_allocated() over
set-up and window (the peak is reset at the run's start)."""


def read(rec):
    return rec.memory_peak_bytes / 2 ** 30 if rec.memory_peak_bytes else None
