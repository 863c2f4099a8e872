"""Seconds from the start of the process to the first timed request."""


def read(rec):
    return rec["setup_s"]
