"""``run_host_ms`` (ms): the mean host time of the program's
``casper.run`` span in the traced window: one ``CasperEngine.run``,
placement and its whole block loop, from inside the program (the
counterpart of ``host_issue_ms``, the benchmark's clock around it)."""
from spans import mean_us


def read(rec):
    us = mean_us(rec, "casper.run")
    return None if us is None else us / 1e3
