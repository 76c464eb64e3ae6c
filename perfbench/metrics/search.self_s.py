"""search.self_s: the search's own host seconds per discovery: the self
time of its ``discover.point`` and ``discover.round`` spans (moves, the
argmax, grouping N_ijk), from the program's profiled spans; moves
``discovery_s``."""

from perfbench.span_readers import SEARCH, self_seconds


def read(rec):
    return self_seconds(rec, SEARCH)
