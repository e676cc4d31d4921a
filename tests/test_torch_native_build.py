"""The shared build-and-load path of the port's native code
(``impersonator_tpu_torch/utils/native_build.py``), on a few-line C
source compiled with g++ into a temporary build directory: a library is built once and then reused, a changed source or
flag builds under a new name, a failed build raises with the compiler's
output, and a bound entry point carries its table's types. This file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_native_build.py
"""

import ctypes
import shutil

import pytest

from impersonator_tpu_torch.utils import native_build
from torch_threads import one_torch_thread  # noqa: F401

CXX = shutil.which("g++") or "g++"
SOURCE = 'extern "C" int add3(int a, int b) { return a + b + 3; }\n'
TABLE = {"add3": (ctypes.c_int, [ctypes.c_int, ctypes.c_int])}


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build"
    monkeypatch.setattr(native_build, "BUILD_DIR", out)
    return out


def _job(src, *flags):
    return ("add3", src, [CXX, "-shared", "-fPIC", *flags, str(src)])


def test_second_build_reuses_the_library(tmp_path, build_dir, monkeypatch):
    src = tmp_path / "add3.cpp"
    src.write_text(SOURCE)
    (path,), log = native_build.build([_job(src)])
    assert path.parent == build_dir and path.exists()
    assert sorted(p.name for p in build_dir.iterdir()) == [path.name]

    def no_compiler(*args, **kwargs):
        raise AssertionError("a built library was compiled again")

    monkeypatch.setattr(native_build.subprocess, "Popen", no_compiler)
    (again,), log = native_build.build([_job(src)])
    assert again == path and log == ""


@pytest.mark.parametrize("change", ["source", "flag"])
def test_a_change_builds_a_new_library(tmp_path, build_dir, change):
    src = tmp_path / "add3.cpp"
    src.write_text(SOURCE)
    (first,), _ = native_build.build([_job(src)])
    if change == "source":
        src.write_text(SOURCE + 'extern "C" int unused() { return 0; }\n')
        job = _job(src)
    else:
        job = _job(src, "-O1")
    (second,), _ = native_build.build([job])
    assert second != first
    assert first.exists() and second.exists()


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         build_dir):
    src = tmp_path / "broken.cpp"
    src.write_text("int broken() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name") as err:
        native_build.build([_job(src)])
    assert str(src) in str(err.value)
    assert not list(build_dir.glob("*.so"))


def test_bind_gives_each_symbol_its_types(tmp_path, build_dir):
    src = tmp_path / "add3.cpp"
    src.write_text(SOURCE)
    (path,), _ = native_build.build([_job(src)])
    lib = native_build.bind(path, TABLE)
    assert lib.add3.restype is ctypes.c_int
    assert lib.add3.argtypes == [ctypes.c_int, ctypes.c_int]
    assert lib.add3(4, 5) == 12
