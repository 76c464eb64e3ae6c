"""mobius.blocks_s: seconds per discovery of the Mobius join's block
assembly from cached positives (the self time of the program's
``mobius.blocks`` spans); moves ``discovery_s``."""

from perfbench.span_readers import self_seconds


def read(rec):
    return self_seconds(rec, ("mobius.blocks",))
