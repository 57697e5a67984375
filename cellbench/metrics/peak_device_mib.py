"""peak_device_mib (MiB): the most the card's allocator held over the
window (`torch.cuda.max_memory_allocated`, reset at the window's start)."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**20
