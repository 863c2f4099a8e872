"""Disparity maps served in the window over its seconds (host clock): the
frames/s of the served cells, whose host path makes them noisier than the
device-bound ``fps``."""

from portbench.spec import metric_reader

read = metric_reader("fps")
