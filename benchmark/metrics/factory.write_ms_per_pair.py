"""Host milliseconds a pair in the factory's writeback (`factory.host_write`:
the nav read, encode and write of each `<name>_train.nc`), over the
batches whose writeback ended inside the window."""


def read(run):
    n = run.counts.get("write_batches", 0)
    if not n:
        return None
    return run.counts["write_s"] / (n * run.config["factory"]["batch_size"]) * 1e3
