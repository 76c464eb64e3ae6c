"""exec.upload_s: host seconds per discovery of the executors' copies to
the device (the program's ``exec.upload`` spans: the host's side of the
copies ``device.h2d_ms`` times on the card); moves ``discovery_s``."""

from perfbench.span_readers import span_seconds


def read(rec):
    return span_seconds(rec, ("exec.upload",))
