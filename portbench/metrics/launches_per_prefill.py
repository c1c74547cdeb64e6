"""Device launches (kernels, copies, sets) the host issued inside
``engine.insert`` ranges of the traced sub-window, per insertion."""
UNIT = "launches"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["insert_spans"]:
        return None
    return tr["launches_in_inserts"] / tr["insert_spans"]
