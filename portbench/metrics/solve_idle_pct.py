"""The device's idle time in the node solver outside its host syncs: the
idle gaps that begin inside ``node.solve`` but outside its ``sync`` spans
(the launch-bound inner loop), in % of the untraced seconds that
``device_idle_pct`` divides by, from the join of the program's spans with
a traced window (``portbench.spans``). None where the join cannot be
trusted."""

from portbench import spans


def read(ctx):
    j = spans.trusted(ctx)
    return None if j is None else j.solve_idle_pct()
