"""The share of the window in which no operation ran on the card
(the device trace's busy union), in %."""


def read(ctx):
    if not ctx["trace"]:
        return None
    return (1.0 - ctx["trace"]["busy_s"] / ctx["window_s"]) * 100.0
