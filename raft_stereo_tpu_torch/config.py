"""Model configuration and the device rule of the port's entry points.

The port keeps its own copy of the JAX package's ``RAFTStereoConfig`` and
CLI flags (flag names identical to the reference CLIs) rather than importing
them: the port imports nothing from ``raft_stereo_tpu``.

Correlation choices:
- ``reg``: the all-pairs volume and pyramid with a plain torch lookup (fp32).
- ``reg_cuda``: the same volume with the hand-written CUDA lookup kernel.
  ``reg_tpu`` is accepted as its alias, so JAX configurations load as is.
- ``alt``, ``alt_cuda``, ``alt_tpu``: not ported yet (ROADMAP Queue B,
  "alt"); they raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

import torch

CORR_IMPLEMENTATIONS = ("reg", "alt", "reg_tpu", "alt_tpu", "reg_cuda", "alt_cuda")
CORR_ALIASES = {"reg_tpu": "reg_cuda"}
_NOT_PORTED = ("alt", "alt_cuda", "alt_tpu")


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

    def __post_init__(self):
        self.hidden_dims = tuple(self.hidden_dims)
        if self.corr_implementation not in CORR_IMPLEMENTATIONS:
            raise ValueError(
                f"corr_implementation must be one of {CORR_IMPLEMENTATIONS}, "
                f"got {self.corr_implementation!r}")
        if self.corr_implementation in _NOT_PORTED:
            raise NotImplementedError(
                f"corr_implementation {self.corr_implementation!r} is not "
                "ported yet (ROADMAP Queue B: the alt memory path)")
        if self.slow_fast_gru:
            raise NotImplementedError(
                "slow_fast_gru is not ported yet (ROADMAP Queue A, update block)")
        if self.n_gru_layers not in (1, 2, 3):
            raise ValueError(f"n_gru_layers must be 1, 2 or 3, got {self.n_gru_layers}")
        if len(self.hidden_dims) != 3:
            raise ValueError(f"hidden_dims must have 3 entries, got {self.hidden_dims}")
        if self.n_downsample not in (2, 3):
            raise ValueError(f"n_downsample must be 2 or 3, got {self.n_downsample}")

    @property
    def corr_kind(self) -> str:
        """``reg`` or ``reg_cuda`` after resolving the alias."""
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
