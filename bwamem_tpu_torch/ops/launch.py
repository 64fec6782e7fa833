"""The one launch path of the port's hand-written CUDA kernels.

Every kernel library is one source under csrc/, compiled with nvcc for
sm_90a into the repository's build/ directory at its first load and loaded
with ctypes.  Each C entry takes device pointers and ints, then the raw
stream last, launches on that stream without synchronising and returns
cudaGetLastError() as an int.  A Library binds those entries once and
launches them:

  * on the caller's current stream of the tensors' device, taken as a raw
    handle from torch._C._cuda_getCurrentRawStream (what Triton's launcher
    and Inductor's generated code use): no device context and no Stream
    object on the way;
  * with that device current: the runtime's current device is switched
    only when the index differs from torch.cuda.current_device(), and put
    back after the call;
  * checking the code the entry returns: a non-zero code raises
    RuntimeError naming the kernel and the CUDA error, and the wrapper,
    which counts a launch only after launch() returns, counts nothing.

Nothing here touches CUDA when imported: the CPU tests import every
module, and this build of torch may have no CUDA at all.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def raw_stream(index: int) -> int:
    """The raw handle (a cudaStream_t as an int) of the caller's current
    stream on CUDA device `index`: the value of
    torch.cuda.current_stream(index).cuda_stream."""
    return torch._C._cuda_getCurrentRawStream(index)


def caller_streams(devices) -> dict:
    """{device: torch.cuda.Stream}, the caller's current stream of each
    CUDA device of `devices`: for work the caller hands to another thread,
    which makes them current there (utils/fetchguard's copies)."""
    return {d: torch.cuda.current_stream(d) for d in devices}


def launch(fn, name: str, index: int, args: tuple) -> None:
    """fn(*args, stream) on the caller's current stream of CUDA device
    `index`, with that device current; RuntimeError when the entry returns
    a non-zero CUDA error code."""
    if index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


class Library:
    """The C entries of one CUDA source (csrc/<source>), built and bound at
    the first load.  `entries` maps each entry to its arguments before the
    stream (ctypes.c_void_p for a pointer, ctypes.c_int for an int);
    `flags` go to nvcc after NVCC_FLAGS (the compiler's output is kept in
    build/<library>.log)."""

    def __init__(self, source: str, entries: dict[str, list],
                 flags: list[str] = ()):
        self.src = os.path.join(CSRC, source)
        self.so_name = "lib" + os.path.splitext(source)[0] + ".so"
        self.entries = entries
        self.flags = list(flags)
        self._fns = None
        self._cdll = None
        self._values = {}
        self._lock = threading.Lock()

    def load(self) -> dict:
        """{entry: bound ctypes function}, building the library at the
        first call; raises on a failed build."""
        if self._fns is None:
            with self._lock:
                if self._fns is None:
                    from bwamem_tpu_torch._build import shared_lib
                    lib = ctypes.CDLL(shared_lib(
                        self.src, self.so_name,
                        [nvcc(), *NVCC_FLAGS, *self.flags]))
                    fns = {}
                    for name, argtypes in self.entries.items():
                        fn = getattr(lib, name)
                        fn.restype = ctypes.c_int
                        fn.argtypes = [*argtypes, ctypes.c_void_p]
                        fns[name] = fn
                    self._cdll = lib
                    self._fns = fns
        return self._fns

    def value(self, entry: str, *ints: int) -> int:
        """entry(*ints) of a C entry that launches nothing and returns a
        long long the library computes (a size), building the library at
        the first call."""
        fn = self._values.get(entry)
        if fn is None:
            self.load()
            fn = getattr(self._cdll, entry)
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_int] * len(ints)
            self._values[entry] = fn
        return int(fn(*ints))

    def launch(self, entry: str, index: int, args: tuple,
               name: str | None = None) -> None:
        """The entry on device `index` through launch(); `name` (default:
        the entry) is the kernel's name in an error."""
        launch(self.load()[entry], name or entry, index, args)
