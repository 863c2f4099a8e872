"""The port's ``obs/`` package on the CPU: the ledger and the profiler
window.

- Ledger: the H100 peaks by device name (the PCIe card apart, the CPU off
  the table), rows' estimates and absent fields, the MFU join that never
  divides blind, ``analyze_program`` (flops from ``FlopCounterMode``, of a
  twin where given; no memory fields off the card), the ``report`` CLI; and
  the flops of the port's plain forward at 128x256 within 5% of the JAX
  package's XLA cost analysis of its twin, at 1 iteration and on the
  per-iteration slope (the counter counts convolutions and matrix products,
  XLA elementwise operations too).
- Profiler: the window's guarded toggle, Chrome traces written, and the
  device seconds as the union of intervals.
"""

import json
import subprocess
import sys

import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import init_raft_stereo as jx_init
from raft_stereo_tpu.models import raft_stereo_forward as jx_forward

from raft_stereo_tpu_torch import RAFTStereoConfig
from raft_stereo_tpu_torch.bench import plain_twin
from raft_stereo_tpu_torch.obs import ledger as lg
from raft_stereo_tpu_torch.obs import profiler as pf
from raft_stereo_tpu_torch.obs.metrics import MetricsRegistry


def _key(kind, b=1, h=64, w=96, iters=2):
    return (kind, b, h, w, iters, ("fp",))


# ---------------------------------------------------------------------------
# Ledger.


def test_chip_peaks_table():
    assert lg.chip_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert lg.chip_peaks("NVIDIA H100 SXM5 80GB") == (989e12, 3.35e12)
    assert lg.chip_peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    assert lg.hbm_capacity("NVIDIA H100 80GB HBM3") == 80 * 2**30
    for kind in ("cpu", None, "", "NVIDIA A100-SXM4-80GB"):
        assert lg.chip_peaks(kind) is None
    assert lg.hbm_capacity("cpu") is None


def test_ledger_estimates_and_absent_fields():
    led = lg.ProgramLedger()
    adv = led.record(_key("advance", b=2, iters=4), kind="advance", b=2, h=64, w=96, iters=4,
                     scan_scale=4, analysis={"flops": 100.0, "bytes_accessed": 10.0,
                                             "argument_bytes": 5.0, "output_bytes": 3.0,
                                             "temp_bytes": 2.0, "alias_bytes": 1.0})
    assert adv.flops_est == 400.0 and adv.bytes_est == 40.0
    assert adv.peak_hbm_bytes == 9.0
    assert adv.roofline((1e12, 1e10)) == "hbm-bound"  # 10 flop/byte under a ridge of 100
    assert adv.roofline((1e12, 1e12)) == "compute-bound"
    full = led.record(_key("full", iters=32), kind="full", iters=32, scan_scale=1,
                      analysis={"flops": 9.0, "bytes_accessed": None})
    assert full.flops_est == 9.0 and full.bytes_est is None
    assert full.peak_hbm_bytes is None and full.roofline((1e12, 1e11)) is None
    none = led.record(_key("prepare"), kind="prepare", analysis={"flops": 7.0})
    assert none.flops_est is None  # no scale, no estimate
    assert led.annotate(_key("prepare"), flops_est=8.0).flops_est == 8.0
    assert led.annotate(_key("missing"), flops_est=1.0) is None
    assert len(led) == 3 and led.drop(_key("prepare")) is none and len(led) == 2
    row = led.rows_by_id([adv.id])[0]
    assert row["roofline"] is None and row["peak_hbm_bytes"] == 9.0  # no peaks for its kind


def test_ledger_attribution_never_divides_blind():
    led = lg.ProgramLedger()
    led.record(_key("segment"), kind="segment", iters=2, scan_scale=1,
               analysis={"flops": 50.0})
    reg = MetricsRegistry()
    reg.counter("raft_program_flops_total", kind="segment").inc(100.0)
    assert led.attribution(reg, peaks=(1e12, 1e11))["segment"]["mfu"] is None
    reg.counter("raft_program_device_seconds_total", kind="segment").inc(2.0)
    att = led.attribution(reg, peaks=(1e12, 1e11))
    assert att["segment"]["mfu"] == pytest.approx(100.0 / 2.0 / 1e12)
    assert led.attribution(reg, device_kind="cpu")["segment"]["mfu"] is None
    att = led.attribution(reg, device_kind="NVIDIA H100 80GB HBM3")
    assert att["segment"]["mfu"] == pytest.approx(100.0 / 2.0 / 989e12)
    reg.counter("raft_program_device_seconds_total", kind="full").inc(1.0)
    assert led.attribution(reg, peaks=(1e12, 1e11))["full"]["mfu"] is None


def test_analyze_program_counts_flops_and_no_memory_off_the_card():
    x = torch.randn(1, 8, 16, 16)
    w = torch.randn(4, 8, 3, 3)

    def conv(a):
        return torch.nn.functional.conv2d(a, w, padding=1)

    want = 2.0 * 4 * 8 * 9 * 16 * 16
    a = lg.analyze_program(conv, x)
    assert a["flops"] == want
    assert all(a[k] is None for k in a if k != "flops")  # no bytes, no memory on the CPU
    twin_calls = []
    b = lg.analyze_program(lambda t: t + 1, x,
                           twin=lambda: twin_calls.append(1) or conv(x.to("meta")))
    assert b["flops"] == want and twin_calls == [1]
    assert lg.count_flops(lambda: x + 1) is None


def test_ledger_report_cli(tmp_path, capsys):
    """The report's exit codes in process, and once through ``python -m``."""
    led = lg.ProgramLedger()
    key = _key("prepare")
    led.record(key, kind="prepare", h=64, w=96, scan_scale=1,
               analysis={"flops": 5.0, "argument_bytes": 10.0, "output_bytes": 2.0,
                         "temp_bytes": 1.0, "alias_bytes": 0.0})
    path = tmp_path / "LEDGER.json"
    lg.save_doc(led.to_doc(cache_keys=[key], backend="cpu"), str(path))
    res = subprocess.run([sys.executable, "-m", "raft_stereo_tpu_torch.obs.ledger", "report",
                          str(path)], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "complete" in res.stdout, res.stdout + res.stderr
    lg.save_doc(led.to_doc(cache_keys=[key, _key("segment")], backend="cpu"), str(path))
    assert lg.main(["report", str(path)]) == 1
    assert "no ledger row" in capsys.readouterr().out
    path.write_text(json.dumps({"schema": 1, "rows": [None], "cache": [], "missing": []}))
    assert lg.main(["report", str(path)]) == 2
    assert "malformed ledger row" in capsys.readouterr().err
    path.write_text("{not json")
    assert lg.main(["report", str(path), "--json"]) == 2


def _jax_twin_flops(h, w, iters):
    """XLA's cost analysis of the JAX package's fp32 reg forward, unrolled
    (its bench's twin), lowered from parameter shapes alone."""
    cfg = JaxConfig(corr_implementation="reg", fused_update=False)
    shapes = jax.eval_shape(lambda: jx_init(jax.random.PRNGKey(0), cfg))
    img = jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32)

    def fwd(p, a, b):
        return jx_forward(p, cfg, a, b, iters=iters, test_mode=True, unroll=True)[1]

    return jax.jit(fwd).lower(shapes, img, img).cost_analysis()["flops"]


def test_plain_twin_flops_match_jax_cost_analysis():
    h, w = 128, 256
    ours = [lg.count_flops(plain_twin(RAFTStereoConfig(), 1, h, w, n)) for n in (1, 2)]
    ref = [_jax_twin_flops(h, w, n) for n in (1, 2)]
    assert ours[0] / ref[0] == pytest.approx(1.0, abs=0.05)
    assert (ours[1] - ours[0]) / (ref[1] - ref[0]) == pytest.approx(1.0, abs=0.05)


# ---------------------------------------------------------------------------
# Profiler.


def test_profiler_disabled_without_dir(monkeypatch):
    monkeypatch.delenv("RAFT_PROFILE_DIR", raising=False)
    p = pf.ProfilerWindow()
    assert not p.enabled
    assert p.start() is False
    assert p.stop() is None
    assert p.status()["refused"] == 1


def test_profiler_window_counts_and_writes_traces(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_PROFILE_DIR", str(tmp_path))
    p = pf.ProfilerWindow()
    assert p.start() is True
    assert p.start() is False  # serialized: a nested window is refused
    torch.ones(64, 64) @ torch.ones(64, 64)
    first = p.stop()
    assert p.stop() is None
    with p.window() as opened:
        assert opened is True
        assert p.status()["active"]
    st = p.status()
    assert st["windows"] == 2 and st["refused"] == 1 and not st["active"]
    assert first.startswith(str(tmp_path)) and len(list(tmp_path.glob("trace-*.json"))) == 2
    json.loads(open(first).read())


def test_device_seconds_is_the_union_of_intervals():
    assert pf.busy_seconds([(0.0, 10.0), (5.0, 20.0), (30.0, 35.0)]) == pytest.approx(25e-6)
    assert pf.busy_seconds([(30.0, 35.0), (0.0, 40.0)]) == pytest.approx(40e-6)
    assert pf.busy_seconds([]) == 0.0
    assert pf.profile_device_seconds(lambda: torch.ones(8) + 1) is None  # no device events
