"""peak_mem_gb.encode: the allocator's peak over the window
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`), GB."""


def read(run):
    if run.peak_window_bytes is None or run.traffic["entry"] == "decode":
        return None
    return run.peak_window_bytes / 1e9
