"""``launches_per_solve`` (count): the kernels the program launched per
solve in the window, from its counters
(``repro_torch.kernels.engine.LAUNCHES``, all kernels summed)."""


def read(rec):
    c = rec.counters
    if not c.get("solves"):
        return None
    return c["launches"] / c["solves"]
