"""The device's idle time that the port's host syncs leave: the idle gaps
that begin inside a ``sync`` span, in % of the untraced seconds that
``device_idle_pct`` divides by (so the parts add up), from the join of the
program's spans with a traced window (``portbench.spans``). None where the
join cannot be trusted: a sync span lacks its runtime copy or sync record
(the clocks disagree), or a launch lacks its device record."""

from portbench import spans


def read(ctx):
    j = spans.trusted(ctx)
    return None if j is None else j.sync_idle_pct()
