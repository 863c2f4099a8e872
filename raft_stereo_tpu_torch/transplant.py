"""Weights into the port's modules.

- :func:`params_from_jax` turns the JAX package's parameter pytree (as numpy
  arrays) into a reference-layout state dict: HWIO conv kernels become OIHW,
  frozen-BN ``scale/bias/mean/var`` become ``weight/bias/running_mean/
  running_var`` (plus ``num_batches_tracked``), and a residual block's
  shortcut norm is written under both ``downsample.1`` and ``norm3``, as the
  reference registers it twice. This is the inverse of the JAX package's
  checkpoint transplant, written against the reference layout so the port
  imports nothing from the JAX package.
- :func:`sep_conv_gru_from_jax` and :func:`bottleneck_block_from_jax` do
  the same for the two reference modules the stereo model does not use
  (``SepConvGRU``, ``BottleneckBlock``), so both packages run them on the
  same weights.
- :func:`load_state_dict` loads a reference state dict strictly, after
  stripping the ``module.`` prefix the reference's DataParallel checkpoints
  carry; :func:`load_pth` reads a ``.pth`` file first.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(out: StateDict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def _norm(out: StateDict, name: str, p: Mapping, norm_fn: str) -> None:
    if norm_fn == "batch":
        out[f"{name}.weight"] = _t(p["scale"])
        out[f"{name}.bias"] = _t(p["bias"])
        out[f"{name}.running_mean"] = _t(p["mean"])
        out[f"{name}.running_var"] = _t(p["var"])
        out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    elif norm_fn == "group":
        out[f"{name}.weight"] = _t(p["scale"])
        out[f"{name}.bias"] = _t(p["bias"])


def _residual_block(out: StateDict, name: str, p: Mapping, norm_fn: str) -> None:
    _conv(out, f"{name}.conv1", p["conv1"])
    _conv(out, f"{name}.conv2", p["conv2"])
    _norm(out, f"{name}.norm1", p["norm1"], norm_fn)
    _norm(out, f"{name}.norm2", p["norm2"], norm_fn)
    if "downsample" in p:
        _conv(out, f"{name}.downsample.0", p["downsample"]["conv"])
        _norm(out, f"{name}.downsample.1", p["downsample"]["norm"], norm_fn)
        _norm(out, f"{name}.norm3", p["downsample"]["norm"], norm_fn)


def _trunk(out: StateDict, prefix: str, p: Mapping, norm_fn: str, stages) -> None:
    _conv(out, f"{prefix}.conv1", p["conv1"])
    _norm(out, f"{prefix}.norm1", p["norm1"], norm_fn)
    for stage in stages:
        for j, blk in enumerate(p[stage]):
            _residual_block(out, f"{prefix}.{stage}.{j}", blk, norm_fn)


def params_from_jax(np_params: Mapping, cfg: RAFTStereoConfig) -> StateDict:
    """JAX parameter pytree (numpy leaves) -> the port's state dict."""
    out: StateDict = {}
    cnet = np_params["cnet"]
    _trunk(out, "cnet", cnet, "batch",
           ("layer1", "layer2", "layer3", "layer4", "layer5"))
    for scale in ("outputs08", "outputs16"):
        for j, head in enumerate(cnet[scale]):
            _residual_block(out, f"cnet.{scale}.{j}.0", head["res"], "batch")
            _conv(out, f"cnet.{scale}.{j}.1", head["conv"])
    for j, head in enumerate(cnet["outputs32"]):
        _conv(out, f"cnet.outputs32.{j}", head["conv"])
    ub = np_params["update_block"]
    for c in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(out, f"update_block.encoder.{c}", ub["encoder"][c])
    for g in ("gru08", "gru16", "gru32"):
        for conv in ("convz", "convr", "convq"):
            _conv(out, f"update_block.{g}.{conv}", ub[g][conv])
    _conv(out, "update_block.flow_head.conv1", ub["flow_head"]["conv1"])
    _conv(out, "update_block.flow_head.conv2", ub["flow_head"]["conv2"])
    _conv(out, "update_block.mask.0", ub["mask"]["conv1"])
    _conv(out, "update_block.mask.2", ub["mask"]["conv2"])
    for i, conv in enumerate(np_params["context_zqr_convs"]):
        _conv(out, f"context_zqr_convs.{i}", conv)
    if cfg.shared_backbone:
        _residual_block(out, "conv2.0", np_params["conv2"]["res"], "instance")
        _conv(out, "conv2.1", np_params["conv2"]["conv"])
    else:
        fnet = np_params["fnet"]
        _trunk(out, "fnet", fnet, "instance", ("layer1", "layer2", "layer3"))
        _conv(out, "fnet.conv2", fnet["conv2"])
    return out


def sep_conv_gru_from_jax(np_params: Mapping) -> StateDict:
    """The JAX package's ``init_sep_conv_gru`` tree (numpy leaves) -> a
    ``SepConvGRU`` state dict."""
    out: StateDict = {}
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(out, name, np_params[name])
    return out


def bottleneck_block_from_jax(np_params: Mapping, norm_fn: str) -> StateDict:
    """The JAX package's ``init_bottleneck_block`` tree (numpy leaves) -> a
    ``BottleneckBlock`` state dict; a strided block's shortcut norm under
    both ``downsample.1`` and ``norm4``, as the reference registers it."""
    out: StateDict = {}
    for i in (1, 2, 3):
        _conv(out, f"conv{i}", np_params[f"conv{i}"])
        _norm(out, f"norm{i}", np_params[f"norm{i}"], norm_fn)
    if "downsample" in np_params:
        _conv(out, "downsample.0", np_params["downsample"]["conv"])
        _norm(out, "downsample.1", np_params["downsample"]["norm"], norm_fn)
        _norm(out, "norm4", np_params["downsample"]["norm"], norm_fn)
    return out


def load_state_dict(model: torch.nn.Module, state_dict: Mapping) -> None:
    """Strict load of a reference-layout state dict, ``module.`` stripped."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)


def load_pth(model: torch.nn.Module, path: str) -> None:
    """Load a reference ``.pth`` checkpoint into ``model``."""
    load_state_dict(model, torch.load(path, map_location="cpu", weights_only=True))
