"""engine/build.py without nvcc: a stub `nvcc` script on PATH that
answers `--version` with a release line, and otherwise sleeps, records
its start and writes its `-o` file, with ctypes.CDLL replaced.  Two
threads that make the first load start one build and share one library;
a failing build raises and leaves no temp file; the compiler's release
line is read once and is part of the library's name."""

import os
import stat
import sys
import threading

import pytest

from cyclonus_tpu_torch.engine import build

STUB = """#!{python}
import sys, time
if "--version" in sys.argv:
    with open({log!r}, "a") as f:
        f.write("version\\n")
    print("Cuda compilation tools, release {release}, V{release}.0")
    sys.exit(0)
with open({log!r}, "a") as f:
    f.write("start\\n")
time.sleep({sleep})
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("lib")
sys.exit({rc})
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """Install a stub nvcc (sleep seconds, exit code) in tmp_path/bin and
    an empty build directory; returns the setter and the start log."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    out_dir = tmp_path / "kernels"

    def install(sleep=0.5, rc=0, release="12.8"):
        path = bindir / "nvcc"
        path.write_text(STUB.format(python=sys.executable, log=str(log), sleep=sleep, rc=rc,
                                    release=release))
        path.chmod(path.stat().st_mode | stat.S_IEXEC)

    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setenv("CYCLONUS_TORCH_BUILD_DIR", str(out_dir))
    opened = []
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: opened.append(path) or object())
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_stamps", {})
    return install, log, out_dir, opened


def _starts(log):
    return log.read_text().count("start") if log.exists() else 0


def test_two_threads_start_one_build(stub_nvcc):
    install, log, out_dir, opened = stub_nvcc
    install(sleep=0.5)
    assert build.nvcc() == str(log.parent / "bin" / "nvcc")
    barrier = threading.Barrier(2)
    libs, errors = [], []

    def first_call():
        try:
            barrier.wait()
            libs.append(build.load("packed_counts"))
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(libs) == 2 and libs[0] is libs[1]
    assert _starts(log) == 1
    assert opened == [str(build.library_path("packed_counts"))]
    assert sorted(p.name for p in out_dir.iterdir()) == [build.library_path("packed_counts").name]
    # a later call reuses the library: no nvcc, no second open
    assert build.load("packed_counts") is libs[0]
    assert _starts(log) == 1 and len(opened) == 1


def test_parallel_build_of_every_source(stub_nvcc):
    install, log, out_dir, _opened = stub_nvcc
    install(sleep=0.2)
    seconds = build.build()
    assert sorted(seconds) == sorted(build.SOURCES) and all(s > 0 for s in seconds.values())
    assert _starts(log) == len(build.SOURCES)
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        build.library_path(n).name for n in build.SOURCES)
    # built: nothing to do
    assert set(build.build().values()) == {0.0}
    assert _starts(log) == len(build.SOURCES)


def test_failed_build_raises_and_leaves_no_temp_file(stub_nvcc):
    install, log, out_dir, opened = stub_nvcc
    install(sleep=0.1, rc=3)
    with pytest.raises(RuntimeError, match="nvcc exited 3"):
        build.load("dense_counts")
    assert _starts(log) == 1
    assert list(out_dir.iterdir()) == []
    assert opened == [] and build._loaded == {}
    # a stub that fails in both of two threads: each raises, no file stays
    errors = []

    def first_call():
        try:
            build.load("dense_counts")
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(errors) == 2
    assert list(out_dir.iterdir()) == []


def test_temp_path_is_pid_unique_beside_the_library(tmp_path):
    out = tmp_path / "libx-0123.so"
    tmp = build.temp_path(out)
    assert tmp.parent == out.parent and tmp.name == f"libx-0123.{os.getpid()}.tmp"


def test_compiler_stamp_is_read_once_and_keys_the_library(stub_nvcc):
    """The release line of `nvcc --version` is read once a process and
    is part of the digest: another release names another library, so a
    kept build directory never serves a library another nvcc built."""
    install, log, out_dir, _opened = stub_nvcc
    install(sleep=0.0, release="12.8")
    assert build.compiler_stamp() == "Cuda compilation tools, release 12.8, V12.8.0"
    first = build.library_path("packed_counts")
    assert build.library_path("packed_counts") == first
    assert log.read_text().count("version") == 1
    assert build.library_path("packed_counts", compiler=build.compiler_stamp()) == first
    assert build.library_path("packed_counts", compiler="release 12.9") != first
    build.build()
    assert _starts(log) == len(build.SOURCES)
    # a toolkit upgrade (a fresh process: the stamp is read anew) rebuilds
    install(sleep=0.0, release="12.9")
    build._stamps.clear()
    assert build.library_path("packed_counts") != first
    assert set(build.build().values()) != {0.0}
    assert _starts(log) == 2 * len(build.SOURCES)
    assert len(list(out_dir.iterdir())) == 2 * len(build.SOURCES)


def test_no_nvcc_raises(tmp_path, monkeypatch):
    """Without nvcc the library's name cannot be known: load raises, as
    it did before the stamp was in the key (there is no fallback)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_stamps", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("packed_counts")
