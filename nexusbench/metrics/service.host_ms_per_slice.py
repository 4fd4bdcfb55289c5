"""The sweep service's host time a slice: the window's seconds in which
no operation ran on the card, over the engine slices the window ran,
in ms."""


def read(ctx):
    slices = ctx["stats1"]["n_slices"] - ctx["stats0"]["n_slices"]
    busy = ctx["trace"]["busy_s"] if ctx["trace"] else None
    if not slices or busy is None:
        return None
    return (ctx["window_s"] - busy) / slices * 1e3
