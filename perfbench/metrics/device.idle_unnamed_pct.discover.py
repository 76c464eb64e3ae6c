"""device.idle_unnamed_pct.discover: the share of the window's device-idle
time in which no span of the program but ``discover.run`` is open,
between discoveries included: the idle card the spans cannot name yet,
in %; moves ``discovery_s``."""

from perfbench.span_readers import idle_unnamed_pct as read  # noqa: F401
