"""``launch_host_us`` (us): the mean host time of the program's
``casper.launch`` span in the traced window: one K1-K4 launch in
``kernels/engine.py`` (pack factor, load path, argument packing, the
call into the library)."""
from spans import mean_us


def read(rec):
    return mean_us(rec, "casper.launch")
