"""The recordable-entry registry: WHAT graftverify analyzes.

Entries are built from the port's real builders — ``serve/session.py``'s
``build_program`` (the exact callables the session captures as CUDA
graphs), ``engine/steps.py``'s ``TrainStep`` (the exact train step, AdamW
and OneCycle included) and the eval forward — so the GV checkers walk the
programs the port runs rather than hand-written stand-ins.

Geometries:

- ``headline``: the bench's headline shape (Middlebury-F padded,
  2016x2976, 32 iterations, segments of 8, ``reg_cuda`` in bf16).  The
  ladder walk and the knob flips live here, and only on a CUDA device: on
  the CPU every kernel wrapper runs its plain version, so a rung or knob
  that turns a kernel off records the same program there and the proofs
  would be vacuous (the JAX package's "ladder/knob probes are
  headline-only", for the same kind of reason).
- ``small``: a fast shape for any device; every entry, no probes.

Everything is lazy: ``TraceEntry.build`` closures defer the work to the
runner, which turns a failing entry into a GV000 finding instead of a
crash.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KnobProbe:
    """Where and how one env knob changes the recorded program: ``flip`` is
    a value different from the default; ``kind``/``batch`` pick the serving
    program the knob engages on; ``env`` holds extra (key, value) pairs
    applied to BOTH the base and the flipped recording."""

    flip: str
    kind: str = "full"
    batch: int = 1
    env: Tuple[Tuple[str, str], ...] = ()


#: One probe per registered env knob: a value that must change the recorded
#: program at headline, on the program where the knob engages.  A knob added
#: to ENV_KNOBS without a probe here is itself a GV102 finding.
KNOB_FLIP_PROBES: Dict[str, KnobProbe] = {
    "RAFT_STREAM_TAIL": KnobProbe("0"),      # default on -> off
    "RAFT_FUSE_GRU1632": KnobProbe("0"),     # default on -> off
    "RAFT_FUSED_ENCODERS": KnobProbe("0"),   # default on -> off
    "RAFT_FUSE_ITER": KnobProbe("0"),        # default on -> off
    "RAFT_CORR_PACK8": KnobProbe("1"),       # default OFF -> on
    "RAFT_LANE_PACK8": KnobProbe("1"),       # default OFF -> on
}

GEOMETRIES: Dict[str, Dict[str, int]] = {
    # The bench's headline: RAFT_BENCH_H/W defaults, 32 refinement
    # iterations, segments of iters // 4 (the serving default of four
    # segments).  ``probe_iters`` is what the ladder and knob programs run:
    # whether a rung or a knob changes a program does not depend on it.
    "headline": dict(h=2016, w=2976, iters=32, seg_iters=8, probe_iters=32),
    "small": dict(h=64, w=128, iters=2, seg_iters=1, probe_iters=2),
}

#: Train-step geometry for both registries: the checks on the step (host
#: round trips, constants, updates in place) do not depend on the frame.
TRAIN_GEOMETRY = dict(h=64, w=96, batch=1, iters=2)

#: Where the refinement loop is, for GV101: the function holding it and
#: the fp32 accumulator it updates.
LOOP = ("raft_stereo_tpu_torch.models.raft_stereo", "_segment_carry",
        "coords1")

#: Modules whose ``*_plain`` functions stand where a hand-written kernel
#: runs on the card (their bodies are exempt from GV101, as a kernel's are).
KERNEL_MODULES = ("raft_stereo_tpu_torch.ops.encoder", "raft_stereo_tpu_torch.ops.stream",
                  "raft_stereo_tpu_torch.ops.resident",
                  "raft_stereo_tpu_torch.corr.reg_cuda",
                  "raft_stereo_tpu_torch.corr.alt_cuda")

#: The fixed seeds of the registry's weights and frames.
SEED = 0

#: Table suppressions of the real registry, ``(code, context) -> reason``:
#: none. (The pools' fp32 upcasts feed their sums: not findings. The
#: resize to gru08's size is gru16+32's sixth stage in every bf16 program
#: recorded here, and the resize to gru16's its third: no program's loop
#: reaches ``ops/resize.py:interp_align_corners`` outside a kernel.)
SUPPRESSIONS: Dict[Tuple[str, str], str] = {}


@dataclasses.dataclass
class TraceEntry:
    """One recordable program.

    build: ``() -> (fn, args)`` or ``(fn, args, state)``, called by the
        runner inside the entry's env override window, so the program's
        switch reads see exactly ``env``; ``state()`` names the program's
        own tensors (parameters, buffers, optimizer state).
    env: FULLY RESOLVED kernel-switch mapping (``None`` = unset).
    mixed_precision: GV101 applies (the program computes in bf16).
    in_place: GV105 applies: the program must update ``state`` in place.
    fetches: sites (``module.py:Qualname``) whose host fetch the program
        declares: GV103 lets the round trips at a declared site through.
    """

    name: str
    build: Callable[[], Tuple]
    env: Dict[str, Optional[str]]
    mixed_precision: bool = False
    in_place: bool = False
    fetches: Tuple[str, ...] = ()


@dataclasses.dataclass
class KnobFlip:
    """One GV102 knob probe: flipping ``knob`` to ``flip_value`` must change
    the recorded program IFF it changes the program-cache key.  ``flipped``
    is None when no probe is declared for a registered knob."""

    knob: str
    flip_value: Optional[str]
    base: TraceEntry
    flipped: Optional[TraceEntry]
    base_key: object = None
    flipped_key: object = None


@dataclasses.dataclass
class TraceRegistry:
    """Everything one graftverify run analyzes, plus its thresholds,
    table suppressions ``(code, context) -> reason`` (a reasonless one is a
    GV000 finding) and what the recorder needs to place an op: the
    refinement loop (``region``, a ``() -> graphs.Region``) and the
    kernel modules whose plain versions stand for kernels."""

    geometry: str
    entries: List[TraceEntry]
    ladder_variants: List[Tuple[str, TraceEntry]]
    knob_flips: List[KnobFlip]
    suppressions: Dict[Tuple[str, str], str] = dataclasses.field(
        default_factory=dict)
    gv101_min_elements: int = 4096
    gv104_const_bytes: int = 2 * 1024 * 1024
    region: Optional[Callable[[], object]] = None
    kernel_modules: Tuple[str, ...] = ()

    def all_entries(self) -> List[TraceEntry]:
        seen: Dict[str, TraceEntry] = {}
        for e in self.entries:
            seen.setdefault(e.name, e)
        for _, e in self.ladder_variants:
            seen.setdefault(e.name, e)
        for kf in self.knob_flips:
            seen.setdefault(kf.base.name, kf.base)
            if kf.flipped is not None:
                seen.setdefault(kf.flipped.name, kf.flipped)
        return list(seen.values())


def session_cache_key(kind: str, h: int, w: int, iters: int, cfg, env, b: int = 1):
    """The key ``InferenceSession.cache_key`` gives a program, computed by
    the session's own method on a session that holds nothing else."""
    import threading
    import types

    from raft_stereo_tpu_torch.serve.session import InferenceSession
    stub = types.SimpleNamespace(_env=dict(env), _env_base=dict(env), _run_cfg=cfg,
                                 _mesh_lock=threading.Lock(), _mesh_live=None,
                                 _mesh_n=1, _mesh_epoch=0)
    stub._resolve = functools.partial(InferenceSession._resolve, stub)
    stub._fingerprint = functools.partial(InferenceSession._fingerprint, stub)
    return InferenceSession.cache_key(stub, kind, h, w, iters, cfg, env, b=b)


def headline_refusal() -> Optional[str]:
    """Why the headline registry cannot run here, or None on a CUDA
    device."""
    import torch
    if torch.cuda.is_available():
        return None
    return ("--trace-geometry headline needs a CUDA device (the ladder and "
            "knob probes record the kernels' launches); use --trace-geometry "
            "small on the CPU")


def default_registry(geometry: str = "headline", device: Optional[str] = None
                     ) -> TraceRegistry:
    """The port's registry: six serving program kinds, the eval forward and
    the train step, with the ladder walk and the knob flips at headline,
    which refuses a device without the kernels. ``device`` defaults to the
    card when there is one."""
    import torch

    from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, with_eval_precision
    from raft_stereo_tpu_torch.serve.session import (_view, build_program,
                                                     config_fingerprint, resolve_env)

    if geometry not in GEOMETRIES:
        raise ValueError(f"unknown trace geometry {geometry!r} "
                         f"(have {sorted(GEOMETRIES)})")
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    probes = geometry == "headline"
    if probes and dev.type != "cuda":
        raise RuntimeError("the headline registry's ladder and knob probes need a "
                           "CUDA device: on the CPU every kernel wrapper runs its "
                           "plain version")
    g = GEOMETRIES[geometry]
    # The bench's headline config: reg_cuda in the eval bf16 policy; the
    # reference eval config: plain, fp32.
    cfg_serve = with_eval_precision(RAFTStereoConfig(corr_implementation="reg_cuda"))
    cfg_eval = RAFTStereoConfig()
    # Every registered switch unset: the defaults, never the live environment.
    base_env: Dict[str, Optional[str]] = {k: None for k in ENV_KNOBS}

    @functools.lru_cache(maxsize=None)
    def model():
        from raft_stereo_tpu_torch.models.raft_stereo import init_raft_stereo
        torch.manual_seed(SEED)
        return init_raft_stereo(cfg_serve, device=str(dev)).eval()

    def state_of(m) -> Callable[[], Dict]:
        return lambda: {**dict(m.named_parameters()), **dict(m.named_buffers())}

    @functools.lru_cache(maxsize=None)
    def images(batch: int):
        gen = torch.Generator().manual_seed(SEED + batch)
        shape = (batch, g["h"], g["w"], 3)
        return tuple((torch.rand(shape, generator=gen) * 255.0).to(dev) for _ in range(2))

    def carry(run_cfg, batch: int):
        # A carry the prepare program makes, under the live (entry's) env:
        # RAFT_LANE_PACK8 changes what it holds.
        prep = build_program("prepare", _view(model(), run_cfg), 0)
        return prep(*images(batch))[0]

    def serve_entry(name: str, kind: str, iters: int) -> TraceEntry:
        def build():
            m = _view(model(), cfg_serve)
            fn = build_program(kind, m, iters)
            if kind in ("segment", "advance", "epilogue"):
                args = (carry(cfg_serve, 1),)
            elif kind == "prepare_warm":
                f = cfg_serve.downsample_factor
                gen = torch.Generator().manual_seed(SEED + 7)
                flow = (torch.rand((1, g["h"] // f, g["w"] // f, 1), generator=gen)
                        * -8.0).to(dev)
                args = (*images(1), flow)
            else:
                args = images(1)
            return fn, args, state_of(m)
        return TraceEntry(name=name, build=build, env=dict(base_env),
                          mixed_precision=True)

    entries = [
        serve_entry("serve/full", "full", g["iters"]),
        serve_entry("serve/prepare", "prepare", 0),
        serve_entry("serve/prepare_warm", "prepare_warm", 0),
        serve_entry("serve/segment", "segment", g["seg_iters"]),
        serve_entry("serve/advance", "advance", g["seg_iters"]),
        serve_entry("serve/epilogue", "epilogue", 0),
    ]

    def build_eval():
        from raft_stereo_tpu_torch.models.raft_stereo import raft_stereo_forward
        m = _view(model(), cfg_eval)

        def fwd(i1, i2):
            return raft_stereo_forward(m, i1, i2, iters=g["iters"])
        return fwd, images(1), state_of(m)
    entries.append(TraceEntry(name="eval/forward", build=build_eval, env=dict(base_env)))
    entries.append(_train_entry(base_env, dev))

    ladder_variants: List[Tuple[str, TraceEntry]] = []
    knob_flips: List[KnobFlip] = []
    if probes:
        from raft_stereo_tpu_torch.serve.guard import KernelCircuitBreaker
        breaker = KernelCircuitBreaker()
        names = [p.name for p in breaker.ladder]
        pi = g["probe_iters"]
        seg = max(1, pi // 4)
        # Each ladder program is the b=1 full forward AND the b=2 advance in
        # one recording, so that every rung has a program it changes (the
        # JAX package's walk). The walk starts ARMED (int8 correlation and
        # lanes on): an opt-in rung can only be non-vacuous from there, the
        # state it exists to degrade from.
        ladder_base = resolve_env({"RAFT_CORR_PACK8": "1", "RAFT_LANE_PACK8": "1"},
                                  base_env)

        def ladder_build(run_cfg):
            def build():
                m = _view(model(), run_cfg)
                full_fn = build_program("full", m, pi)
                adv_fn = build_program("advance", m, seg)

                def combined(i1, i2, state2):
                    return full_fn(i1, i2), adv_fn(state2)
                return combined, (*images(1), carry(run_cfg, 2)), state_of(m)
            return build

        ladder_variants.append(("untripped", TraceEntry(
            name="serve/full+advance@ladder:0:armed", build=ladder_build(cfg_serve),
            env=dict(ladder_base))))
        for k in range(1, len(names) + 1):
            run_cfg, env_over = breaker.apply(cfg_serve, tripped=tuple(names[:k]))
            ladder_variants.append((names[k - 1], TraceEntry(
                name=f"serve/full+advance@ladder:{k}:{names[k - 1]}",
                build=ladder_build(run_cfg), env=resolve_env(env_over, ladder_base))))

        def probe_build(kind: str, batch: int):
            def build():
                m = _view(model(), cfg_serve)
                iters = seg if kind in ("segment", "advance") else pi
                fn = build_program(kind, m, iters)
                if kind in ("segment", "advance", "epilogue"):
                    return fn, (carry(cfg_serve, batch),), state_of(m)
                return fn, images(batch), state_of(m)
            return build

        probe_bases: Dict[Tuple, TraceEntry] = {}
        for knob in ENV_KNOBS:
            probe = KNOB_FLIP_PROBES.get(knob)
            if probe is None:
                knob_flips.append(KnobFlip(knob, None, entries[0], None))
                continue
            bk = (probe.kind, probe.batch, probe.env)
            base_probe_env = resolve_env(dict(probe.env), base_env)
            if bk not in probe_bases:
                suffix = "".join(f"@{k}={v}" for k, v in probe.env)
                probe_bases[bk] = TraceEntry(
                    name=f"serve/{probe.kind}@b{probe.batch}{suffix}@probe",
                    build=probe_build(probe.kind, probe.batch), env=dict(base_probe_env))
            env = resolve_env({**dict(probe.env), knob: probe.flip}, base_env)
            iters = seg if probe.kind in ("segment", "advance") else pi
            knob_flips.append(KnobFlip(
                knob, probe.flip, probe_bases[bk],
                TraceEntry(name=f"serve/{probe.kind}@b{probe.batch}@knob:{knob}",
                           build=probe_build(probe.kind, probe.batch), env=env),
                base_key=(config_fingerprint(cfg_serve, base_probe_env),
                          session_cache_key(probe.kind, g["h"], g["w"], iters, cfg_serve,
                                            base_probe_env, probe.batch)),
                flipped_key=(config_fingerprint(cfg_serve, env),
                             session_cache_key(probe.kind, g["h"], g["w"], iters,
                                               cfg_serve, env, probe.batch))))

    def region():
        import importlib

        from raft_stereo_tpu_torch.analysis.trace.graphs import loop_region
        mod, fn, acc = LOOP
        return loop_region(getattr(importlib.import_module(mod), fn), acc)

    return TraceRegistry(geometry=geometry, entries=entries,
                         ladder_variants=ladder_variants, knob_flips=knob_flips,
                         suppressions=dict(SUPPRESSIONS), region=region,
                         kernel_modules=KERNEL_MODULES)


def _train_entry(base_env: Dict[str, Optional[str]], dev) -> TraceEntry:
    """The real train step: forward, sequence loss, backward, clip, AdamW
    and OneCycle, with its one declared host fetch (the step's metrics)."""
    import torch

    tg = TRAIN_GEOMETRY

    @functools.lru_cache(maxsize=None)
    def pieces():
        from raft_stereo_tpu_torch.config import RAFTStereoConfig
        from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
        from raft_stereo_tpu_torch.engine.steps import make_train_step
        from raft_stereo_tpu_torch.models.raft_stereo import init_raft_stereo
        torch.manual_seed(SEED + 1)
        model = init_raft_stereo(RAFTStereoConfig(), device=str(dev)).train()
        optimizer = make_optimizer(model, 0.0002, 100, skip_nonfinite=5)
        step = make_train_step(model, optimizer, train_iters=tg["iters"])
        b, h, w = tg["batch"], tg["h"], tg["w"]
        gen = torch.Generator().manual_seed(SEED + 2)
        batch = {"image1": torch.rand((b, h, w, 3), generator=gen) * 255.0,
                 "image2": torch.rand((b, h, w, 3), generator=gen) * 255.0,
                 "flow": torch.rand((b, h, w, 1), generator=gen) * -16.0,
                 "valid": torch.ones((b, h, w))}
        batch = {k: v.to(dev) for k, v in batch.items()}
        step(batch)  # the optimizer's moments exist before the recorded step

        def state():
            out = {**dict(model.named_parameters()), **dict(model.named_buffers())}
            for i, p in enumerate(optimizer.params):
                for k, v in optimizer.adamw.state.get(p, {}).items():
                    if isinstance(v, torch.Tensor) and v.dim() > 0:
                        out[f"adamw[{i}].{k}"] = v
            return out
        return step, batch, state

    def build():
        step, batch, state = pieces()
        return step, (batch,), state

    return TraceEntry(name="train/step", build=build, env=dict(base_env),
                      in_place=True, fetches=("engine/steps.py:TrainStep.__call__",))
