"""device.idle_pct.discover: the share of the discovery window with
nothing on the card (100 minus the union of the trace's device
intervals); moves ``discovery_s``."""

from perfbench.readers import idle_pct as read  # noqa: F401
