"""The card's busy milliseconds in the traced window over the frames
completed in it."""


def read(rec):
    busy = rec.get("busy_s")
    return 1e3 * busy / rec["frames"] if busy and rec.get("frames") else None
