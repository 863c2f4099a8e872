"""Registries of the port's environment knobs (:mod:`.knobs`)."""
