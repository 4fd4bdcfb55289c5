"""The lane tail of the sweep service in this cell: the 95th percentile,
over every lane the window submitted that came back correct, of the time
from its ``submit`` to its result, in ms.  The host paces it here (the
card idles most of the window), so it stands among the per-layer
metrics."""
import numpy as np


def read(ctx):
    lat = [(ln.done - ln.sent) * 1e3 for ln in ctx["good"]]
    return float(np.percentile(lat, 95)) if lat else None
