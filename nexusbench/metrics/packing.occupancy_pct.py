"""Admission and packing: the mean share of the resident super-lanes'
PE rows that carried a live lane, over the window's slices (the sweep
service's ``refill_occupancy``, taken over the window), in %."""


def read(ctx):
    s0, s1 = ctx["stats0"], ctx["stats1"]
    slices = s1["n_slices"] - s0["n_slices"]
    if not slices:
        return None
    return (s1["occupancy_sum"] - s0["occupancy_sum"]) / slices * 100.0
