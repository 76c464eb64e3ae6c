"""exec.host_ids_s: host seconds per discovery of the executors' segment
id, gather and code arithmetic before each hop's copy (the program's
``exec.host_ids`` spans); moves ``discovery_s``."""

from perfbench.span_readers import span_seconds


def read(rec):
    return span_seconds(rec, ("exec.host_ids",))
