"""``mca_matmul_fixed``'s share of its roofline in the traced sub-window
(``counts/mca_matmul_fixed.py``)."""
from portbench.metrics import _common

UNIT = "%"


def read(ctx):
    return _common.roofline(ctx, "mca_matmul_fixed")
