"""The caching allocator's peak of allocated device bytes over the
window (torch.cuda.max_memory_allocated, reset at its start), in GB."""


def read(w):
    if w.peak_device_bytes is None:
        return None
    return w.peak_device_bytes / 1e9
