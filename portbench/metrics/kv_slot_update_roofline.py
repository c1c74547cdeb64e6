"""``kv_slot_update``'s share of its roofline in the traced sub-window
(``counts/kv_slot_update.py``)."""
from portbench.metrics import _common

UNIT = "%"


def read(ctx):
    return _common.roofline(ctx, "kv_slot_update")
