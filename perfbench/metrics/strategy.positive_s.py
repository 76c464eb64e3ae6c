"""strategy.positive_s: seconds of pre- and post-counting's positive
phase per discovery (``CostStats.time_positive``, the paper's Fig. 3
split; the timers synchronise the card); moves ``discovery_s``."""

from perfbench.readers import mean


def read(rec):
    return mean(rec, "positive_s")
