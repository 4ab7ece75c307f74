"""The allocator's peak over the window (`torch.cuda.max_memory_allocated`
after `reset_peak_memory_stats` at its start), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30
