"""``verify_s`` (s): the seconds the process spent in the static
verification of new plans, at read time
(``repro_torch.analysis.counters()["seconds"]``): set-up's, since
nothing lowers in the window."""


def read(rec):
    from repro_torch import analysis
    return analysis.counters().get("seconds")
