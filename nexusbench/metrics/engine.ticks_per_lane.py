"""The engine chunk loop's wall ticks (chunks run x chunk length) over
the window, per lane the window completed."""


def read(ctx):
    ticks = ctx["stats1"]["engine_ticks"] - ctx["stats0"]["engine_ticks"]
    n = len(ctx["in_window"])
    return ticks / n if n else None
