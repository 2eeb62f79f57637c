"""95th percentile, over every batch completed inside the window, of the
time from handing the batch to the entry until its outputs reached the
host callback."""
import numpy as np


def read(run):
    lat = run.counts.get("batch_ms")
    if not lat:
        return None
    return float(np.percentile(lat, 95))
