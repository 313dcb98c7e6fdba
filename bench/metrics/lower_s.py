"""``lower_s`` (s): the seconds the process spent lowering plans, at read
time (``repro_torch.core.plan.PLAN_CACHE.stats()["lower_s"]``): set-up's,
since nothing lowers in the window."""


def read(rec):
    from repro_torch.core import plan
    return plan.PLAN_CACHE.stats().get("lower_s")
