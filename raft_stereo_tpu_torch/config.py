"""Model configuration and the device rule of the port's entry points.

The port keeps its own copy of the JAX package's ``RAFTStereoConfig`` and
CLI flags (flag names identical to the reference CLIs) rather than importing
them: the port imports nothing from ``raft_stereo_tpu``.

Correlation choices:
- ``reg``: the all-pairs volume and pyramid with a plain torch lookup (fp32).
- ``reg_cuda``: the same volume with the hand-written CUDA lookup kernel.
  ``reg_tpu`` is accepted as its alias, so JAX configurations load as is.
- ``alt``: no volume; per lookup, the 2r+1 pooled fmap2 vectors around
  each position dotted with fmap1, plain torch in fp32 (:mod:`.corr.alt`).
- ``alt_cuda``: the same with the hand-written CUDA alt kernel, the feature
  maps in their own dtype (:mod:`.corr.alt_cuda`). ``alt_tpu`` is accepted
  as its alias. The memory path for full-resolution frames.

Four switches, read from the environment at call time under the JAX
package's names, default on, off for ``0``/``false``/``no``/``off``:
- ``RAFT_FUSE_GRU1632`` (the gru16+32 co-schedule kernel) and
  ``RAFT_FUSE_ITER`` (the resident iteration kernel). Off, the loop runs the
  serial lookup, motion and ConvGRU kernels.
- ``RAFT_FUSED_ENCODERS`` (the encoders' stem, streamed 3x3 pass and
  point2/point3 kernels of ``ops/encoder.py``). Off, the encoders run plain
  convolutions with torch norms between them. ``RAFT_STREAM_TAIL`` (the
  stride-1 second blocks of layer2/layer3 and the finest heads through those
  kernels) only matters while the first is on; off, only stem + layer1 fuse.
Only a caller flips them; nothing does on an error.

One more, ``RAFT_CORR_PACK8``, defaults OFF and is on only for
``1``/``true``/``yes``/``on``: ``reg_cuda`` quantizes a bf16 pyramid to
int8 levels with per-sample, per-level scales when it builds the operands,
and the lookup and the resident kernels dequantize the taps they read. Its
result is not the bf16 path's bits (each tap is within half a scale step),
so an operator opts in. It does nothing for fp32 volumes or the other
correlation choices.

``RAFT_LANE_PACK8`` parses the same way and defaults OFF too: in test mode
the loop-invariant context (each GRU level's zqr conv output) and the two
feature maps ride the carry as int8 values with a per-sample fp32 scale
(``corr/reg_cuda.py:Lane8``), dequantized once a segment, and the GRU
kernels read the folded czrq context as int8 (``ops/stream.py:
prepare_gru_context_any``). Each value moves by up to half a scale step, so
it is opt-in as well. A carry's containers are dequantized whatever the
switch says when the segment runs; a czrq container reaching the resident
kernel while the switch is off raises.
"""

from __future__ import annotations

import argparse
import contextlib
import contextvars
import dataclasses
import os
from typing import Iterator, Optional, Tuple

import torch

CORR_IMPLEMENTATIONS = ("reg", "alt", "reg_tpu", "alt_tpu", "reg_cuda", "alt_cuda")
CORR_ALIASES = {"reg_tpu": "reg_cuda", "alt_tpu": "alt_cuda"}
_OFF = ("0", "false", "no", "off")
_ON = ("1", "true", "yes", "on")


def _switch_on(name: str) -> bool:
    return os.environ.get(name, "1").strip().lower() not in _OFF


def fuse_gru1632_on() -> bool:
    """``RAFT_FUSE_GRU1632``: gru32 and gru16 in one kernel launch."""
    return _switch_on("RAFT_FUSE_GRU1632")


def fuse_iter_on() -> bool:
    """``RAFT_FUSE_ITER``: lookup, motion encoder, gru08 and FlowHead in one
    kernel launch."""
    return _switch_on("RAFT_FUSE_ITER")


def corr_pack8_on() -> bool:
    """``RAFT_CORR_PACK8``: int8 correlation levels for ``reg_cuda``; default
    off, read when the operands are built."""
    return os.environ.get("RAFT_CORR_PACK8", "0").strip().lower() in _ON


def lane_pack8_on() -> bool:
    """``RAFT_LANE_PACK8``: int8 context lanes in test mode; default off."""
    return os.environ.get("RAFT_LANE_PACK8", "0").strip().lower() in _ON


_PLAIN_ENCODERS = contextvars.ContextVar("raft_plain_encoders", default=False)


def fused_encoders_on() -> bool:
    """``RAFT_FUSED_ENCODERS``: the encoder kernels (``ops/encoder.py``),
    unless the caller is inside :func:`plain_encoders`."""
    return not _PLAIN_ENCODERS.get() and _switch_on("RAFT_FUSED_ENCODERS")


@contextlib.contextmanager
def plain_encoders() -> Iterator[None]:
    """The encoders run plain inside: the height-sharded forward's rule (the
    JAX package turns its encoder kernels off under a ``space`` mesh)."""
    token = _PLAIN_ENCODERS.set(True)
    try:
        yield
    finally:
        _PLAIN_ENCODERS.reset(token)


def stream_tail_on() -> bool:
    """``RAFT_STREAM_TAIL``: the encoders' stride-1 tail blocks and finest
    heads through the encoder kernels too."""
    return _switch_on("RAFT_STREAM_TAIL")


@dataclasses.dataclass
class RAFTStereoConfig:
    """Architecture and precision (reference: the ``args`` namespace)."""

    corr_implementation: str = "reg"
    shared_backbone: bool = False
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2
    slow_fast_gru: bool = False
    n_gru_layers: int = 3
    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    # bf16 compute with fp32 parameters; the correlation lookup accumulates
    # in fp32 either way. In bf16 the refinement loop's GRU and motion
    # kernels engage; in fp32 the loop runs the plain torch modules.
    mixed_precision: bool = False
    # Engage the loop kernels in training too (the JAX package's meaning):
    # their forward is the kernel, their backward plain torch recomputed
    # from the saved inputs. Off by default, as in the JAX package: a
    # training step then runs the loop as plain torch in bf16, and only the
    # correlation kernels and the encoder kernels at B=1 engage.
    fused_train: bool = False

    def __post_init__(self):
        self.hidden_dims = tuple(self.hidden_dims)
        if self.corr_implementation not in CORR_IMPLEMENTATIONS:
            raise ValueError(
                f"corr_implementation must be one of {CORR_IMPLEMENTATIONS}, "
                f"got {self.corr_implementation!r}")
        if self.n_gru_layers not in (1, 2, 3):
            raise ValueError(f"n_gru_layers must be 1, 2 or 3, got {self.n_gru_layers}")
        if len(self.hidden_dims) != 3:
            raise ValueError(f"hidden_dims must have 3 entries, got {self.hidden_dims}")
        if self.n_downsample not in (2, 3):
            raise ValueError(f"n_downsample must be 2 or 3, got {self.n_downsample}")

    @property
    def corr_kind(self) -> str:
        """``reg``, ``reg_cuda``, ``alt`` or ``alt_cuda``, after resolving
        the aliases."""
        return CORR_ALIASES.get(self.corr_implementation, self.corr_implementation)

    @property
    def context_dims(self) -> Tuple[int, ...]:
        return self.hidden_dims

    @property
    def downsample_factor(self) -> int:
        return 2 ** self.n_downsample

    @property
    def cor_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    @classmethod
    def from_namespace(cls, ns: argparse.Namespace) -> "RAFTStereoConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in fields})

    def loop_kernels(self, test_mode: bool) -> bool:
        """Whether the refinement loop runs the GRU and motion kernels: bf16,
        and in training also ``fused_train``."""
        return self.mixed_precision and (test_mode or self.fused_train)


@dataclasses.dataclass
class TrainConfig:
    """Training parameters (the reference's train_stereo.py flags), with
    every field of the JAX package's ``TrainConfig``."""

    name: str = "raft-stereo"
    restore_ckpt: Optional[str] = None
    batch_size: int = 6
    train_datasets: Tuple[str, ...] = ("sceneflow",)
    lr: float = 0.0002
    num_steps: int = 100000
    image_size: Tuple[int, int] = (320, 720)
    train_iters: int = 16
    valid_iters: int = 32
    wdecay: float = 1e-5
    # Data augmentation
    img_gamma: Optional[Tuple[float, float]] = None
    saturation_range: Optional[Tuple[float, float]] = None
    do_flip: Optional[str] = None  # False/'h'/'v' in the reference CLI
    spatial_scale: Tuple[float, float] = (0.0, 0.0)
    noyjitter: bool = False
    # Loader threads; None sizes them from SLURM_CPUS_PER_TASK - 2, as the
    # reference's loader does.
    num_workers: Optional[int] = None
    seed: int = 1234
    ckpt_every: int = 10000  # the reference's validation and checkpoint cadence
    # Profile one steady-state step (torch.profiler) into this directory.
    trace_dir: Optional[str] = None
    # Each sample's height split over this many processes (one card each),
    # the rest of the processes forming the data axis (parallel/mesh.py).
    spatial_shard: int = 1
    # A non-finite step is skipped (parameters, Adam moments and the
    # schedule untouched); the run aborts after this many consecutive ones.
    # 0 aborts on the first, as the reference does. ``restore_ckpt`` may
    # name a directory: resume from its newest valid bundle.
    max_bad_steps: int = 5
    # Keep-last-K over the periodic checkpoints; 0 keeps all. Preempt,
    # epoch and final bundles are never pruned.
    keep_ckpts: int = 3
    # Per-sample load retries before quarantine and substitution, and the
    # base seconds of the exponential backoff between them.
    data_retries: int = 2
    data_retry_backoff: float = 0.05

    def __post_init__(self):
        self.train_datasets = tuple(self.train_datasets)
        self.image_size = tuple(self.image_size)
        self.spatial_scale = tuple(self.spatial_scale)
        if self.do_flip is False:
            self.do_flip = None

    @classmethod
    def from_namespace(cls, ns: argparse.Namespace) -> "TrainConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in fields})


def eval_mixed_precision(cfg: RAFTStereoConfig) -> bool:
    """The inference bf16 policy: on when requested, or when a kernel-backed
    correlation is selected (its lookup accumulates in fp32 in-kernel)."""
    return (cfg.mixed_precision
            or cfg.corr_implementation.endswith(("_cuda", "_tpu")))


def with_eval_precision(cfg: RAFTStereoConfig) -> RAFTStereoConfig:
    """``cfg`` with :func:`eval_mixed_precision` applied (same object when
    nothing changes)."""
    mp = eval_mixed_precision(cfg)
    if mp == cfg.mixed_precision:
        return cfg
    return dataclasses.replace(cfg, mixed_precision=mp)


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """Architecture flags, identical to the reference CLIs."""
    parser.add_argument('--corr_implementation', choices=list(CORR_IMPLEMENTATIONS),
                        default="reg", help="correlation volume implementation")
    parser.add_argument('--shared_backbone', action='store_true',
                        help="use a single backbone for the context and feature encoders")
    parser.add_argument('--corr_levels', type=int, default=4,
                        help="number of levels in the correlation pyramid")
    parser.add_argument('--corr_radius', type=int, default=4,
                        help="width of the correlation pyramid")
    parser.add_argument('--n_downsample', type=int, default=2,
                        help="resolution of the disparity field (1/2^K)")
    parser.add_argument('--slow_fast_gru', action='store_true',
                        help="iterate the low-res GRUs more frequently")
    parser.add_argument('--n_gru_layers', type=int, default=3,
                        help="number of hidden GRU levels")
    parser.add_argument('--hidden_dims', nargs='+', type=int, default=[128] * 3,
                        help="hidden state and context dimensions")
    parser.add_argument('--mixed_precision', action='store_true',
                        help='use mixed precision (bfloat16 compute)')


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: raft_stereo_tpu_torch runs on the GPU by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
