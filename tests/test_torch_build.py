"""bwamem_tpu_torch/_build.shared_lib on the CPU: a library is built at
first use, reused while it is at least as new as its inputs, and rebuilt
when a header that its source includes with quotes changes (the column-0
gather's csrc/col0.cuh is included by two kernel sources this way)."""
import ctypes
import os

from bwamem_tpu_torch import _build

CXX = ["c++", "-x", "c++", "-O0", "-shared", "-fPIC"]


def _value(path):
    lib = ctypes.CDLL(path)
    lib.value.restype = ctypes.c_int
    return lib.value()


def test_a_library_is_rebuilt_when_an_included_header_changes(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src, header = tmp_path / "probe.cc", tmp_path / "probe_value.h"
    header.write_text("#define VALUE 1\n")
    src.write_text('#include "probe_value.h"\n'
                   'extern "C" int value() { return VALUE; }\n')
    t = os.path.getmtime(src)
    os.utime(header, (t, t))
    first = _build.shared_lib(str(src), "libprobe_1.so", CXX)
    assert _value(first) == 1
    built = os.path.getmtime(first)
    assert _build.shared_lib(str(src), "libprobe_1.so", CXX) == first
    assert os.path.getmtime(first) == built          # reused, not rebuilt
    header.write_text("#define VALUE 2\n")
    os.utime(header, (built + 10, built + 10))
    # a new name: the loader keeps the library it already mapped
    os.replace(first, str(tmp_path / "build" / "libprobe_2.so"))
    os.utime(str(tmp_path / "build" / "libprobe_2.so"), (built, built))
    assert _value(_build.shared_lib(str(src), "libprobe_2.so", CXX)) == 2
