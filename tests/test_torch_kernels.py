"""The kernel build on the host (``raft_stereo_tpu_torch/kernels.py``), with a
stand-in compiler: one ``nvcc`` a source, started together, each source's
wall seconds returned, the compiler's output kept beside the library, and a
failed source raising with that output. No CUDA toolkit is needed."""

import os
import stat

import pytest

from raft_stereo_tpu_torch import kernels

# Writes the library named after -o, after a delay a source names, and prints
# a ptxas-like line; exits 1 for a source named "corr_alt".
_FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
name=$(basename "$src" .cu)
echo "ptxas info    : Used 42 registers ($name)"
case "$name" in
  corr_alt) echo "error: refused"; exit 1 ;;
  gru1632) sleep 1.5 ;;
esac
echo built > "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_build_times_each_source_and_keeps_its_log(fake_toolkit):
    seconds = kernels.build(["conv_gru", "gru1632"])
    assert set(seconds) == {"conv_gru", "gru1632"}
    assert seconds["gru1632"] >= 1.5 and seconds["conv_gru"] < seconds["gru1632"]
    for name in seconds:
        assert kernels.library_path(name).read_text() == "built\n"
        assert f"Used 42 registers ({name})" in kernels.build_log(name)
    assert sorted(os.listdir(fake_toolkit)) == sorted(
        p.name for n in seconds for p in (kernels.library_path(n),
                                          kernels.library_path(n).with_suffix(".log")))
    assert kernels.build(["conv_gru", "gru1632"]) == {}  # built: nothing to do


def test_build_failure_raises_with_the_compiler_output(fake_toolkit):
    with pytest.raises(RuntimeError, match="(?s)corr_alt: nvcc exit 1.*error: refused"):
        kernels.build(["corr_alt", "motion"])
    assert not kernels.library_path("corr_alt").exists()
    assert kernels.library_path("motion").exists()
    assert sorted(os.listdir(fake_toolkit)) == sorted(
        p.name for p in (kernels.library_path("motion"),
                         kernels.library_path("motion").with_suffix(".log")))


def test_count_launch_counts_a_stage_beside_the_variant(monkeypatch):
    """A launch that ran an optional stage counts once in ``launches`` and
    under its variant and its stage each, so the variant's count is the
    same with and without the stage; listeners get both tags."""
    monkeypatch.setattr(kernels, "launches", type(kernels.launches)())
    monkeypatch.setattr(kernels, "variants", type(kernels.variants)())
    heard = []

    def listener(kernel, variant):
        heard.append((kernel, variant))

    kernels.add_launch_listener(listener)
    try:
        kernels.count_launch("gru1632", "lane8", "up08")
        kernels.count_launch("gru1632", "lane8")
        kernels.count_launch("gru1632", None, "up08")
        kernels.count_launch("gru1632")
    finally:
        kernels.remove_launch_listener(listener)
    assert kernels.launches == {"gru1632": 4}
    assert kernels.variants == {"gru1632:lane8": 2, "gru1632:up08": 2}
    assert heard == [("gru1632", "lane8+up08"), ("gru1632", "lane8"), ("gru1632", "up08"),
                     ("gru1632", None)]
