#!/usr/bin/env python3
"""Times the column-0 gather out[q] = tab[k[q], 0] (bwamem_tpu_torch/csrc/
col0.cuh: rows 6D and 7C of the kernel table) against the design it
replaced, against variants of it and against its library call, on one
NVIDIA GPU, in one process.

    python3 tools/torch_col0_variants.py

Two inputs from numpy (seed 0), a [78208, 8] int32 table at 1024 lanes
(tools/pl_gather_probe2.py's probe_d, row 6D) and at 8 lanes
(tools/pl_gather_probe3.py's probe_d2, row 7C), and these calls:
  shipped    gp2_col0 (6D) and gp3_col0 (7C) as they are: ops/col0, then
             col0_kernel launched with programmatic dependent launch;
  no_pdl     col0.cuh launched without the attribute (its
             griddepcontrol instructions then return at once);
  block256, block512, block1024
             col0.cuh with that many threads a block past one warp
             (shipped: COL0_BLOCK);
  replaced   the design col0.cuh replaced: gp2's kernel (blocks of 128
             threads) and gp3's (one warp striding the lanes), launched
             with <<<>>>, behind the checks of ops/gather_probe._check and
             torch.empty_like;
  library    tab[k64, 0] with k64 = k as int64, made beforehand.
Each variant is a textual patch of col0.cuh (or, for replaced, that design's
source) built with the same nvcc flags into its own library under
build/col0_variants/, and called through the same Python as shipped
(ops/col0.launch) but replaced.  Every call's output must equal the plain
version first (exit 1 otherwise).  Then each input runs the calls in
turns, in the order above and then in reverse, six rounds, each call
timed as rows 6D and 7C are (torch_pl_gather_probe2.call_times: `ms` and
`device_ms` over 200 back-to-back calls, `single_ms` one call between
events, `issue_us` on the host clock), and each number is the median of
its six.  Then the shipped call's host issue part by part
(`issue_parts`, torch_dispatch_probe.issue_us on stubs, in turns too).
Prints the card's name and power limit, then one line per call.
chip_smoke.py times only shipped, replaced and library this way
(compare with the libraries of ("replaced",)).
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

ROWS, W = 78208, 8
LANES = {"6D": 1024, "7C": 8}
ROUNDS = 6                  # rounds of the calls in turns (A..Z, Z..A, ...)
BLOCK = "#define COL0_BLOCK 128"
NO_PDL = ("    cfg.numAttrs = 1;\n", "    cfg.numAttrs = 0;\n")
HEADER_VARIANTS = {"shipped": (), "no_pdl": (NO_PDL,)}
HEADER_VARIANTS.update({f"block{b}": ((BLOCK, f"#define COL0_BLOCK {b}"),)
                        for b in (256, 512, 1024)})
ENTRY = r'''#include "col0.cuh"
extern "C" int col0_entry(const int* tab, const int* k, int* out, int N,
                          int W, void* stream) {
  return col0_launch(tab, k, out, N, W, (cudaStream_t)stream);
}
extern "C" int col0_noop(const int* tab, const int* k, int* out, int N,
                         int W, void* stream) {
  return 0;
}
'''
# the two kernels and C entries that col0.cuh replaced (gp2_col0_kernel,
# gp3_col0_kernel), as they were
REPLACED = r'''#include <cuda_runtime.h>
__global__ void __launch_bounds__(128)
gp2_col0_kernel(const int* __restrict__ tab, const int* __restrict__ k,
                int* __restrict__ out, int N, int W) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) out[q] = __ldg(tab + (long long)k[q] * W);
}
__global__ void __launch_bounds__(32)
gp3_col0_kernel(const int* __restrict__ tab, const int* __restrict__ k,
                int* __restrict__ out, int N, int W) {
  for (int q = threadIdx.x; q < N; q += 32)
    out[q] = __ldg(tab + (long long)k[q] * W);
}
extern "C" int gp2_col0(const int* tab, const int* k, int* out, int N, int W,
                        void* stream) {
  if (N > 0)
    gp2_col0_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        tab, k, out, N, W);
  return (int)cudaGetLastError();
}
extern "C" int gp3_col0(const int* tab, const int* k, int* out, int N, int W,
                        void* stream) {
  if (N > 0)
    gp3_col0_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(tab, k, out, N, W);
  return (int)cudaGetLastError();
}
'''


# every library the tool builds: the header's variants (its "shipped" one
# gives issue_parts a col0_entry and a no-op entry) and the replaced design
VARIANTS = (*HEADER_VARIANTS, "replaced")


def libraries(names=VARIANTS) -> dict:
    """{variant: ops.launch.Library} for the variants `names` (of
    VARIANTS), the sources written under build/col0_variants/<variant>/
    and built together; raises if a patch no longer applies or a build
    fails."""
    import ctypes
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops.launch import CSRC, Library
    header = open(os.path.join(CSRC, "col0.cuh")).read()
    sig = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    libs = {}
    for name, patches in HEADER_VARIANTS.items():
        if name not in names:
            continue
        text = header
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the patch does not "
                                   f"apply to csrc/col0.cuh")
            text = text.replace(old, new)
        libs[name] = _library(BUILD_DIR, name, {"col0.cuh": text},
                              ENTRY, {"col0_entry": sig, "col0_noop": sig},
                              Library)
    if "replaced" in names:
        libs["replaced"] = _library(BUILD_DIR, "replaced", {}, REPLACED,
                                    {"gp2_col0": sig, "gp3_col0": sig},
                                    Library)
    errors = []

    def build(lib):
        try:
            lib.load()
        except BaseException as e:          # reported after the join
            errors.append(str(e))
    threads = [threading.Thread(target=build, args=(lib,))
               for lib in libs.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def _library(build_dir, name, headers, source, entries, Library):
    d = os.path.join(build_dir, "col0_variants", name)
    os.makedirs(d, exist_ok=True)
    for fname, text in {**headers, f"col0_{name}.cu": source}.items():
        path = os.path.join(d, fname)
        if not os.path.exists(path) or open(path).read() != text:
            with open(path, "w") as f:
                f.write(text)
    lib = Library("col0.cuh", entries)
    lib.src = os.path.join(d, f"col0_{name}.cu")
    lib.so_name = f"libcol0_{name}.so"
    return lib


def replaced_call(lib, entry, tab, k):
    """The call path col0.cuh replaced: its checks, torch.empty_like and
    a launch of that design's entry."""
    import torch
    from bwamem_tpu_torch.ops.gather_probe import _check
    _check(entry, tab, "tab")
    if k.dtype != torch.int32 or k.dim() != 1 or not k.is_contiguous() \
            or k.get_device() != tab.get_device() or tab.shape[0] < 1:
        raise ValueError(f"{entry}: k {k.dtype} {tuple(k.shape)}")
    out = torch.empty_like(k)
    lib.launch(entry, out.get_device(), (tab.data_ptr(), k.data_ptr(),
                                         out.data_ptr(), k.numel(),
                                         tab.shape[1]))
    return out


def make_inputs(seed: int, device) -> dict:
    """{row: (tab, k)}: one [ROWS, W] table in [0, 2^20) and each row's
    lanes in [0, ROWS), from numpy with `seed`."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.integers(0, 1 << 20, (ROWS, W),
                                        dtype=np.int32)).to(device)
    return {row: (tab, torch.from_numpy(rng.integers(
        0, ROWS, n, dtype=np.int32)).to(device)) for row, n in LANES.items()}


def calls(libs: dict, tab, k, row: str) -> dict:
    """{variant: a call of tab[k, 0]} for one row's input: shipped, each
    variant of `libs` past the header's shipped one, and library."""
    from bwamem_tpu_torch.ops import col0, gather_probe2, gather_probe3
    shipped = (gather_probe2.gp2_col0 if row == "6D"
               else gather_probe3.gp3_col0)
    entry = "gp2_col0" if row == "6D" else "gp3_col0"
    out = {"shipped": lambda: shipped(tab, k)}
    for name, lib in libs.items():
        if name == "replaced":
            out[name] = lambda lib=lib: replaced_call(lib, entry, tab, k)
        elif name != "shipped":
            out[name] = lambda lib=lib: col0.launch(lib, "col0_entry", tab,
                                                    k)
    k64 = k.long()
    out["library"] = lambda: tab[k64, 0]
    return out


def issue_parts(libs: dict, tab, k, rounds: int = ROUNDS) -> dict:
    """The shipped call's host issue (us a call, issue_us) part by part on
    row 6D's input, the parts taken in turns and each the median of
    `rounds`: the wrapper, its checks and allocation, three ways to
    allocate the output, the launch path with a no-op entry, the ctypes
    call of the entry (with and without the dependent-launch attribute,
    and the replaced design's <<<>>>) and of a no-op entry, the device and
    stream lookups, and the library call."""
    import torch
    from bwamem_tpu_torch.ops import col0, gather_probe2, launch
    from torch_dispatch_probe import issue_us
    index = tab.get_device()
    _, args = col0.prep("gp2_col0", tab, k)
    fns = libs["shipped"].load()
    entry, noop = fns["col0_entry"], fns["col0_noop"]
    entry_no_pdl = libs["no_pdl"].load()["col0_entry"]
    entry_replaced = libs["replaced"].load()["gp2_col0"]
    stream = launch.raw_stream(index)
    n = k.shape[0]
    k64 = k.long()
    parts = {
        "wrapper gp2_col0": lambda: gather_probe2.gp2_col0(tab, k),
        "  col0.prep: checks, allocation": lambda: col0.prep("gp2_col0",
                                                             tab, k),
        "  k.new_empty(N)": lambda: k.new_empty(n),
        "  torch.empty(N, int32, k.device)": lambda: torch.empty(
            n, dtype=torch.int32, device=k.device),
        "  torch.empty_like(k) (replaced)": lambda: torch.empty_like(k),
        "  launch() of a no-op entry": lambda: launch.launch(
            lambda *a: 0, "noop", index, args),
        "  ctypes: col0_entry (cudaLaunchKernelEx)": lambda: entry(*args,
                                                                  stream),
        "  ctypes: col0_entry without PDL": lambda: entry_no_pdl(
            *args, stream),
        "  ctypes: the replaced entry (<<<>>>)": lambda: entry_replaced(
            *args, stream),
        "  ctypes: a no-op entry": lambda: noop(*args, stream),
        "  torch.cuda.current_device()": torch.cuda.current_device,
        "  launch.raw_stream": lambda: launch.raw_stream(index),
        "library tab[k64, 0]": lambda: tab[k64, 0],
    }
    runs = {name: [] for name in parts}
    for i in range(rounds):
        for name in (list(parts) if i % 2 == 0 else list(parts)[::-1]):
            runs[name].append(issue_us(parts[name]))
    return {name: sorted(us)[len(us) // 2] for name, us in runs.items()}


def compare(libs: dict, x: dict, log=print) -> dict:
    """Times the calls of both rows' inputs x (make_inputs) as the module
    says: shipped, the variants of `libs` (libraries) and library.
    Returns {"rows": {row: {variant: interleaved call_times}},
    "max_abs_err": {row: {variant: err}}}; raises when a call's output
    differs from the plain version."""
    import torch
    from bwamem_tpu_torch.ops import col0
    from torch_pl_gather_probe2 import interleaved
    rows, errs = {}, {}
    for row, (tab, k) in x.items():
        fns = calls(libs, tab, k, row)
        want = col0.plain(tab, k).to(torch.int64)
        errs[row] = {}
        for name, fn in fns.items():
            got = fn().to(torch.int64)
            torch.cuda.synchronize()
            errs[row][name] = int((got - want).abs().max().item())
            if errs[row][name]:
                raise RuntimeError(f"{row} {name} differs from the plain "
                                   f"version")
        log(f"col0 variants, {row} ({k.numel()} lanes of [{ROWS},{W}]): "
            f"every call equals the plain version (max_abs_err "
            f"{max(errs[row].values())})")
        rows[row] = interleaved(fns, ROUNDS)
        for name, r in rows[row].items():
            log(f"col0 {row} {name:10s} back to back {r['ms']:.5f} ms a "
                f"call, device alone {r['device_ms']:.5f}, one call "
                f"{r['single_ms']:.5f}, host issue {r['issue_us']:.2f} us "
                f"(medians of {ROUNDS} rounds in turns)")
    return dict(rows=rows, max_abs_err=errs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_col0_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    libs = libraries()
    x = make_inputs(0, torch.device("cuda"))
    try:
        compare(libs, x)
    except RuntimeError as e:
        print(f"torch_col0_variants: {e}", file=sys.stderr)
        return 1
    for name, us in issue_parts(libs, *x["6D"]).items():
        print(f"col0 issue {name:44s} {us:7.2f} us a call (median of "
              f"{ROUNDS} rounds in turns)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
