"""Share of the traced sub-window in which nothing ran on the card."""
UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
