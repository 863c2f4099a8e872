"""The whole step's share of the card's bf16 peak, in %: frames completed
in the traced window times a frame's operations (the reference's, counted
on the meta device at the padded size), over the window's seconds."""

from portbench.costs import PEAK_FLOPS


def read(rec):
    if not rec.get("busy_s") or not rec.get("frames"):
        return None
    return 100.0 * rec["frames"] * rec["flops_per_frame"] / rec["window_s"] / PEAK_FLOPS
