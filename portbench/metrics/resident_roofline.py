"""The resident iteration kernel's share of its roofline, in %: frames x
iterations x the bound of one row-iteration (``costs.resident_cost`` at the
finest level of the padded frame; batch pad rows are no work) over the
device seconds of its launches in the traced window."""

from portbench.costs import arch_of, bound_s, feature_size, resident_cost

KERNEL = "resident_kernel"


def read(rec):
    spent = sum(s for name, s in rec.get("ops", {}).items() if KERNEL in name)
    if not spent:
        return None
    arch = arch_of(rec["config"])
    h, w = feature_size(arch, *rec["padded"])
    work = rec["frames"] * rec["config"]["valid_iters"] * bound_s(*resident_cost(arch, h, w))
    return 100.0 * work / spent
