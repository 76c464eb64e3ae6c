"""exec.launches.discover: K1-K4 launches per discovery (``ops.LAUNCHES``
over the window); moves ``discovery_s``."""

from perfbench.readers import launches_per_unit as read  # noqa: F401
