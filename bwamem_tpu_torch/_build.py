"""Compile the port's native sources into the repository's `build/`
directory at first use (host C with `cc`, CUDA with `nvcc`)."""
from __future__ import annotations

import os
import re
import subprocess
import tempfile

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")


def _inputs_mtime(src: str) -> float:
    """Modification time of `src` or of the newest header it includes
    with quotes (#include "x.cuh", found beside it), whichever is later."""
    with open(src) as f:
        names = re.findall(r'^\s*#include "([^"]+)"', f.read(), re.M)
    here = os.path.dirname(src)
    return max([os.path.getmtime(src)]
               + [os.path.getmtime(os.path.join(here, n)) for n in names])


def shared_lib(src: str, name: str, cmd: list[str],
               libs: tuple[str, ...] = ()) -> str:
    """Path of `build/<name>`, compiled from `src` with `cmd` unless a copy
    at least as new as the source and the headers it includes with quotes
    exists.  The library is written to a
    temporary name and renamed into place, so concurrent builders (test
    workers) never load a half-written file; the compiler's output goes to
    `build/<name>.log`.  Raises RuntimeError with it when the build
    fails."""
    out = os.path.join(BUILD_DIR, name)
    if os.path.exists(out) and os.path.getmtime(out) >= _inputs_mtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=name + ".", suffix=".tmp")
    os.close(fd)
    try:
        r = subprocess.run([*cmd, src, "-o", tmp, *libs], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {name} from {src} failed "
                               f"(rc={r.returncode}):\n{r.stdout}{r.stderr}")
        with open(out + ".log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
