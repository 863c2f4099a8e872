"""Data of the port: format IO (``frame_utils``, with the decode guard that
serving uses), photometric jitter (``photometric``, numpy), the augmentors
(``augmentor``), the datasets and the training mix (``datasets``) and the
loader (``loader``): the JAX package's ``data/`` without OpenCV or C++. Modules are imported where they
are used: ``import raft_stereo_tpu_torch.serve`` needs none of them."""
