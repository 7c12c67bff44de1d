"""``peak_mem_gib``: ``torch.cuda.max_memory_reserved()`` over the window,
after ``empty_cache()`` and ``reset_peak_memory_stats()`` at its start:
the parameters, the optimizer state, the graph's private pool (its
intermediates live there, reserved and never counted as allocated) and
the batch buffers."""


def read(run):
    if run.device.type != "cuda" or run.peak_window_bytes <= 0:
        return None
    return run.peak_window_bytes / 2**30
