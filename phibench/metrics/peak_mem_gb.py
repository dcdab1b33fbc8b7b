"""torch.cuda.max_memory_allocated() over the window, after a reset at
its start, in GB (1e9 bytes); in the CLI cell the largest over the
children, each read in its child. None off the card."""


def read(run):
    if not run.on_card or run.peak_bytes is None:
        return None
    return run.peak_bytes / 1e9
