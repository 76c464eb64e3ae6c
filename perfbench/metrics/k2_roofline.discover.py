"""k2_roofline.discover: K2's least time over its device time, over every
launch of the discovery window, in % (perfbench.roofline's work, the
trace's kernel times); moves ``discovery_s``."""

from perfbench.readers import k2_roofline as read  # noqa: F401
