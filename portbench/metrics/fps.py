"""Disparity maps completed in the window over its seconds (host clock)."""


def read(rec):
    return rec["frames"] / rec["wall_s"] if rec["wall_s"] > 0 else None
