"""The chunk kernel's share of its roofline: the bytes floor of the
sampled launches (``nexusbench/roofline.py::chunk_bytes``, from copies of
the state around each) over the card's HBM bandwidth, against their
device time, in %.  The chunk kernel does no floating-point work, so its
roofline is the bytes one."""
from nexusbench.roofline import peaks


def read(ctx):
    peak = peaks(ctx["device_name"])
    times = [ctx["launch_s"][i] for i in ctx["sample_idx"]]
    if not peak or not times or not sum(times):
        return None
    floor_s = sum(ctx["sample_bytes"]) / peak["hbm_bytes_per_s"]
    return floor_s / sum(times) * 100.0
