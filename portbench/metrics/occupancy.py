"""Mean live rows a scheduler tick advanced in the window (the session's
tick deck, ``obs/deck.py``)."""


def read(rec):
    ticks = rec.get("ticks") or ()
    return sum(t["occupancy"] for t in ticks) / len(ticks) if ticks else None
