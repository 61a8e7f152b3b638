"""What the process holds of the card over the whole run, set-up and window:
``torch.cuda.max_memory_reserved()`` / 1e9, the captured graphs' pools
included."""

UNIT = "GB"
SOURCE = "host_clock"


def read(run):
    return run.memory_reserved / 1e9 if run.memory_reserved else None
