"""``mfu`` (%): the whole window's share of the card's peak.  The
roofline bound of one solve (the larger of its operations at the peak
float64 rate and its compulsory bytes at the memory's peak) times the
solves completed, over the window's host-clock length."""


def read(rec):
    c = rec.counters
    if not c.get("solves") or not c.get("window_s"):
        return None
    return 100.0 * c["bound_s"] * c["solves"] / c["window_s"]
