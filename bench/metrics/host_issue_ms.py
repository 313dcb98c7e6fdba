"""``host_issue_ms`` (ms): the mean host time ``CasperEngine.run`` takes
to return a solve, before the benchmark synchronizes with the device
(the benchmark's own span around the call)."""


def read(rec):
    c = rec.counters
    if not c.get("solves"):
        return None
    return 1e3 * c["issue_s"] / c["solves"]
