"""device.h2d_ms: device milliseconds of host-to-device copies per
discovery (the trace's ``Memcpy HtoD`` events); moves ``discovery_s``."""


def read(rec):
    dev, units = rec.get("device"), rec.get("units")
    if dev is None or not units:
        return None
    seconds, _ = dev.seconds(lambda name: name.startswith("Memcpy HtoD"))
    return 1e3 * seconds / units
