"""``block_host_us`` (us): the mean host time of the program's
``casper.block`` span in the traced window: one fused block's host work
in ``plan.run_owned``, its launch included."""
from spans import mean_us


def read(rec):
    return mean_us(rec, "casper.block")
