"""``resident_roofline`` in the served cells, where it moves ``served_fps``."""

from portbench.spec import metric_reader

read = metric_reader("resident_roofline")
