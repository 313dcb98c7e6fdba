"""``k1_roofline`` (%): the K1 stencil kernels' share of their roofline
in a solve cell: the bound of every solve the trace holds (the solves
completed before it ended) over the summed device time of the program's
stencil kernels (``casper_*``: ``casper_chain_kernel`` in 2-D,
``casper_stream_kernel`` in 3-D) in it."""

PREFIX = "casper_"


def read(rec):
    if rec.trace is None or not rec.counters.get("solves_traced"):
        return None
    busy = rec.trace.kernel_s(PREFIX)
    if busy <= 0:
        return None
    return 100.0 * rec.counters["bound_s"] * rec.counters["solves_traced"] \
        / busy
