"""The card's busy milliseconds inside the device-side ``raft.encode``
ranges (the profiler's mirror of the model's host range onto the card's
timeline) over the frames completed in the window. Reads
``busy_intervals`` and ``ranges`` (``portbench/stages.py``); None without
them, without a device, or where the model opened no such range (a CUDA
graph's replay opens none)."""

from portbench.stages import busy_ms_per_frame

read = busy_ms_per_frame("raft.encode")
