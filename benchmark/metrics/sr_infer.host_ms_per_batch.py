"""Host milliseconds a batch in the SR stage's loop: its staging and launch
(`sr_infer.dispatch`), its wait (`sr_infer.device_sync`) and the harness's
span around the host callback, over the run's batches."""


def read(run):
    n = run.counts.get("batches_all")
    if not n:
        return None
    return run.counts["host_s"] / n * 1e3
