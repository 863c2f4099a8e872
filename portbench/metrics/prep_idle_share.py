"""The share of the traced window in which the card ran nothing while some
thread of the host was preparing a request's input, in %: the idle seconds
under the union of the host's ``raft.validate``, ``raft.pad``,
``raft.copy_in`` and ``raft.upload`` ranges, over ``window_s``. Reads
``busy_intervals`` and ``ranges`` (``portbench/stages.py``); None without
them or without a device."""

from portbench.stages import PREP, idle_under


def read(rec):
    busy, ranges = rec.get("busy_intervals"), rec.get("ranges")
    if not busy or not ranges:
        return None
    prep = [(s, e) for name, s, e, on_device in ranges if name in PREP and not on_device]
    if not prep:
        return None
    return 100.0 * idle_under(prep, busy) / 1e9 / rec["window_s"]
