"""strategy.negative_s: seconds of the Möbius negative phase per
discovery (``CostStats.time_negative``, the paper's Fig. 3 split);
moves ``discovery_s``."""

from perfbench.readers import mean


def read(rec):
    return mean(rec, "negative_s")
