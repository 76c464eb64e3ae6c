"""exec.upload_mb: MB the executors copy to the device per discovery (the
``bytes`` of the program's ``exec.upload`` spans over 1e6); moves
``discovery_s``."""

from perfbench.span_readers import attr_per_unit


def read(rec):
    value = attr_per_unit(rec, "exec.upload", "bytes")
    return None if value is None else value / 1e6
