"""The CUDA build helper of the PyTorch port (`ops/_build.py`) with a stand-in
compiler: it needs no nvcc and no card. The stand-in writes the library and
prints a ptxas-style line, so the tests see which sources were compiled and
which log each call returns."""

import os
import sys

import pytest

from sat_bundleadjust_tpu_torch.ops import _build

FAKE_NVCC = """#!{py}
import sys
src = sys.argv[-1]
with open({calls!r}, "a") as f:
    f.write(src + "\\n")
if "broken" in src:
    print(src + "(1): error: expected a ';'")
    sys.exit(1)
with open(sys.argv[sys.argv.index("-o") + 1], "w") as f:
    f.write("lib")
print("ptxas info    : Used 7 registers, compiled " + src)
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / (name + ".cu")).write_text("// " + name + "\n")
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    calls = tmp_path / "calls.txt"
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(py=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(csrc / "build"))

    def compiled():
        lines = calls.read_text().splitlines() if calls.exists() else []
        calls.write_text("")
        return sorted(os.path.basename(x)[:-3] for x in lines)

    return csrc, compiled


def test_build_keeps_each_log_for_a_fresh_library(fake):
    """A second build compiles nothing and returns the first build's logs;
    a library older than its source, or without its log, is rebuilt."""
    csrc, compiled = fake
    first = _build.build()
    assert compiled() == ["alpha", "beta"]
    assert sorted(first) == ["alpha", "beta"]
    assert all("ptxas info" in first[n] and n + ".cu" in first[n] for n in first)
    assert all(os.path.exists(_build.lib_path(n)) for n in first)

    assert _build.build() == first
    assert compiled() == []

    src = csrc / "alpha.cu"
    later = os.path.getmtime(_build.lib_path("alpha")) + 10
    os.utime(src, (later, later))
    os.remove(_build.log_path("beta"))
    assert _build.build() == first
    assert compiled() == ["alpha", "beta"]


def test_build_failure_names_the_source_and_keeps_no_library(fake):
    csrc, compiled = fake
    (csrc / "broken.cu").write_text("int x\n")
    with pytest.raises(RuntimeError, match=r"broken \(nvcc exit 1\)"):
        _build.build()
    assert compiled() == ["alpha", "beta", "broken"]
    assert not os.path.exists(_build.lib_path("broken"))
    assert not os.path.exists(_build.log_path("broken"))
    assert _build.build(["alpha", "beta"])["alpha"].startswith("ptxas info")
    assert compiled() == []


def test_builds_at_once_compile_each_source_once(fake):
    """Two builds started together (the ranks of a distributed run) take
    turns on the build directory's lock: the second finds the first's
    libraries fresh and returns their logs."""
    import threading

    csrc, compiled = fake
    results = [None, None]

    def run(k):
        results[k] = _build.build()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert compiled() == ["alpha", "beta"]
    assert results[0] == results[1] and sorted(results[0]) == ["alpha", "beta"]
