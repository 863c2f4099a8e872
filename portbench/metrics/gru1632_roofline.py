"""The gru16+32 kernel's share of its roofline, in %: frames x its launches
a frame (one an iteration, two with three-level slow-fast) x the bound of
one row's launch (``costs.gru1632_cost``; batch pad rows are no work) over
the device seconds of its launches in the traced window."""

from portbench.costs import arch_of, bound_s, feature_size, gru1632_cost

KERNEL = "gru1632_kernel"


def read(rec):
    spent = sum(s for name, s in rec.get("ops", {}).items() if KERNEL in name)
    cfg = rec["config"]
    if not spent or cfg["n_gru_layers"] != 3:
        return None
    arch = arch_of(cfg)
    h, w = feature_size(arch, *rec["padded"])
    per_frame = cfg["valid_iters"] * (2 if cfg["slow_fast_gru"] else 1)
    return 100.0 * rec["frames"] * per_frame * bound_s(*gru1632_cost(arch, h, w)) / spent
