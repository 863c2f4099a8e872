"""``device_ms_per_frame`` in the served cells, where it moves ``served_fps``."""

from portbench.spec import metric_reader

read = metric_reader("device_ms_per_frame")
