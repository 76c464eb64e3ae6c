"""search.families: families the structure search scores per discovery
(``StructureSearch.families_scored`` of the search each discovery
builds); moves ``discovery_s``."""

from perfbench.readers import mean


def read(rec):
    return mean(rec, "families")
