"""The 95th percentile of the wall time between consecutive diagnostic
records of the timed call, in ms, over every record of the window; a record
is timed when the driver writes its first file.  None under 20 intervals."""
import numpy as np

MIN_INTERVALS = 20


def read(run):
    gaps = np.diff(np.asarray(run.records))
    if len(gaps) < MIN_INTERVALS:
        return None
    return float(np.percentile(gaps, 95) * 1e3)
