"""Share of the traced window in which the card ran nothing, in %."""


def read(rec):
    busy = rec.get("busy_s")
    return 100.0 * (1.0 - busy / rec["window_s"]) if busy else None
