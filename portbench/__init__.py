"""The benchmark of the PyTorch and CUDA port (``raft_stereo_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once and prints one JSON line; see ``README.md``.
"""
