"""Multi-device execution: data-parallel sharding of the alignment pipeline.

Model (the reference package's parallel/mesh.py, in PyTorch's idiom):

  * ONE host process drives a `Mesh`: an ordered list of torch devices, one
    per shard.  The count must be a power of two (every lane count in the
    pipeline is a power-of-two bucket, so shards always divide evenly).
  * A device may repeat, as in ["cpu", "cpu"] or ["cuda:0", "cuda:0"]:
    every shard then runs on the same device, one after another.  This is
    how the CPU tests and a one-card machine run the sharded path.
  * The FM index and the other read-only tables are REPLICATED: one copy
    per distinct device (`replicated`), so two shards on one card share
    one index.
  * Every device program runs shard-local through `rowmap`: the alignment
    pipeline is data-parallel over reads and lanes, so seeding arenas,
    chaining grids and extension lanes never cross shards.
  * The one global reduction, the paired-end insert-size statistics, is
    computed by the host over the regions of every shard (pair.py runs on
    the host after the shards' results are merged), so every shard pairs
    against the same statistics.

No function here is compiled: `rowmap` runs the plain function once per
shard on shard-local tensors.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


class Mesh:
    """An ordered list of devices, one per shard."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        # id(obj) -> (obj, [copy per shard]) of the objects `replicated`
        # registered; the strong reference keeps an id from being reused
        self._repl: dict[int, tuple] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the mesh; "
                               "pass CPU devices to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {dev} does not exist: "
                               f"{torch.cuda.device_count()} CUDA devices")
    return dev


def make_mesh(devices) -> Mesh:
    """Data-parallel mesh over `devices` (torch devices or their names, in
    shard order; a device may repeat).  Raises ValueError unless the count
    is a power of two, and RuntimeError for a CUDA device that is not
    there."""
    devs = [_device(d) for d in devices]
    n = len(devs)
    if n < 1 or n & (n - 1):
        raise ValueError(f"mesh size must be a power of two, got {n}")
    return Mesh(devs)


def shards(mesh: Mesh | None) -> int:
    """Shard count of `mesh`; 1 for no mesh."""
    return 1 if mesh is None else mesh.size


def to_device(obj, dev: torch.device):
    """`obj` with every tensor in it on `dev`: tensors, tuples (named ones
    too) and dataclasses are walked; anything else (ints, numpy arrays,
    None) is returned as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        vals = [to_device(x, dev) for x in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


def replicated(mesh: Mesh, obj) -> list:
    """One copy of `obj` per shard, made once per distinct device (shards
    on one device share the copy) and cached on the mesh: `rowmap` hands
    each shard its copy whenever `obj` itself is a replicated argument."""
    hit = mesh._repl.get(id(obj))
    if hit is not None and hit[0] is obj:
        return hit[1]
    by_dev: dict = {}
    copies = []
    for dev in mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = to_device(obj, dev)
        copies.append(by_dev[dev])
    mesh._repl[id(obj)] = (obj, copies)
    return copies


def _split(obj, axis: int, s: int, nsh: int, dev):
    """Shard s of nsh of every tensor in `obj` along `axis`, on `dev`."""
    if isinstance(obj, torch.Tensor):
        n = obj.shape[axis]
        if n % nsh:
            raise ValueError(f"rowmap: axis {axis} of size {n} does not "
                             f"split into {nsh} shards")
        k = n // nsh
        return obj.narrow(axis, s * k, k).to(dev)
    if isinstance(obj, tuple):
        vals = [_split(x, axis, s, nsh, dev) for x in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if obj is None:
        return None
    raise TypeError(f"rowmap: cannot shard a {type(obj).__name__}")


def _concat(parts: list, axis: int, dev):
    """The shards' outputs joined along `axis` on `dev` (tuples, named ones
    too, leaf by leaf)."""
    p0 = parts[0]
    if isinstance(p0, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts], dim=axis)
    if isinstance(p0, tuple):
        vals = [_concat([p[i] for p in parts], axis, dev)
                for i in range(len(p0))]
        return type(p0)(*vals) if hasattr(p0, "_fields") else tuple(vals)
    if p0 is None:
        return None
    raise TypeError(f"rowmap: cannot join a {type(p0).__name__}")


def _axis(m) -> int:
    if m is False:
        return 0
    if m == "ax1":
        return 1
    raise ValueError(f"rowmap: a mask entry is True, False or 'ax1', "
                     f"got {m!r}")


def rowmap(mesh: Mesh, fn, statics: tuple = (), repl_mask: tuple = (),
           out_mask=None):
    """`fn(*args, **dict(statics))` run shard by shard over the mesh, with
    the reference's shard_map specs.

    repl_mask[i]: True -> argument i is replicated (its `replicated` copy
    when it has one, else the argument moved to the shard's device; ints,
    None and numpy arrays pass as they are); False -> sharded on axis 0;
    "ax1" -> sharded on axis 1 (a [k, lanes] packed-transport array).  A
    sharded argument may be a tuple of tensors (a NamedTuple of [N, ...]
    grids), split leaf by leaf.

    Outputs are joined on the first device: on axis 0 when `out_mask` is
    None, on axis 1 when it is "ax1", else one False/"ax1" entry per
    output of a tuple-returning `fn`.  Every shard's work is enqueued
    before anything is joined, so shards on distinct cards overlap."""
    kw = dict(statics)
    repl_mask = tuple(repl_mask)

    def run(*args):
        if len(args) != len(repl_mask):
            raise TypeError(f"rowmap: {len(args)} arguments for a mask of "
                            f"{len(repl_mask)}")
        nsh = mesh.size
        outs = []
        for s, dev in enumerate(mesh.devices):
            sargs = []
            for a, r in zip(args, repl_mask):
                if r is True:
                    hit = mesh._repl.get(id(a))
                    sargs.append(hit[1][s] if hit is not None
                                 and hit[0] is a else to_device(a, dev))
                else:
                    sargs.append(_split(a, _axis(r), s, nsh, dev))
            # tensors carry their device: the kernels launch on it
            # (ops/launch) and every op follows its inputs
            outs.append(fn(*sargs, **kw))
        dev0 = mesh.devices[0]
        if out_mask is None or out_mask is False or out_mask == "ax1":
            return _concat(outs, 0 if out_mask in (None, False) else 1,
                           dev0)
        return tuple(_concat([o[i] for o in outs], _axis(m), dev0)
                     for i, m in enumerate(out_mask))
    return run


def over(mesh: Mesh | None, fn, statics: dict, repl_mask: tuple,
         out_mask=None):
    """`fn` with `statics` bound: as it is without a mesh, else run over
    `mesh` by rowmap with the specs given."""
    if mesh is None:
        return functools.partial(fn, **statics)
    return rowmap(mesh, fn, tuple(statics.items()), repl_mask, out_mask)
