"""Multi-host distribution: chunk-sharded alignment over torch.distributed.

Work unit: the ``-K`` chunk — the read batch one ``mem_process_seqs`` call
handles.  Chunks are dealt round-robin to processes (chunk c -> rank
c mod P) and every rank replays the SAME ``n_processed`` offsets the
single-process run would use, so the hash_64 tiebreaks (bwamem.c:534-537)
are unchanged.  The reference computes paired-end insert statistics PER
CHUNK (bwamem.c:1236-1239), so chunk-aligned sharding needs no collective
for byte-identical output: each rank's chunks carry exactly the statistics
the single-process run computes for them.  The one global step is the
ordered merge of the per-rank SAM shards, done by rank 0 after a barrier.

The process group is gloo's on the CPU and on cards alike: no alignment
data crosses processes, the barrier before the merge is the only
collective, and NCCL refuses two ranks on one GPU.  The shard files have
the reference package's format (MAGIC, then length-prefixed records), so
either package can merge the other's shards.
"""
from __future__ import annotations

import datetime
import os
import struct
from dataclasses import dataclass
from typing import Iterator

MAGIC = b"BWSH1\n"
# seconds a rank waits for the others (process-group set-up and the barrier
# before the merge): a rank that dies must not leave the others waiting
# forever, and a slow rank's last chunks must fit inside it
DEFAULT_TIMEOUT = 1800.0


def init_from_env(coordinator: str | None = None,
                  num_processes: int | None = None,
                  process_id: int | None = None) -> tuple[int, int]:
    """torch.distributed's gloo process group from the arguments or the
    environment (BWAMEM_COORDINATOR host:port, BWAMEM_NUM_PROCESSES,
    BWAMEM_PROCESS_ID), with a timeout of DEFAULT_TIMEOUT seconds.
    Returns (process_id, num_processes); (0, 1) and no process group when
    unconfigured (one process).  A failed initialisation raises."""
    coordinator = coordinator or os.environ.get("BWAMEM_COORDINATOR")
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("BWAMEM_NUM_PROCESSES", "0") or 0)
    process_id = process_id if process_id is not None else \
        int(os.environ.get("BWAMEM_PROCESS_ID", "-1") or -1)
    if not coordinator or num_processes <= 1:
        return 0, 1
    if not 0 <= process_id < num_processes:
        raise ValueError(f"BWAMEM_PROCESS_ID {process_id} is not a rank of "
                         f"{num_processes} processes")
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT))
    return process_id, num_processes


def finalize() -> None:
    """Tear the process group down, when there is one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_chunks(batch_iter, process_id: int, num_processes: int,
                 pe: bool = False) -> Iterator[tuple[int, int, list]]:
    """Deal chunks round-robin; yields (chunk_idx, n_processed, batch) for
    this rank's chunks only.  n_processed counts ALL reads in preceding
    chunks (the other ranks' too) — the determinism offset the reference
    threads through mem_process_seqs (fastmap.c:304, n_processed)."""
    n_processed = 0
    for c, batch in enumerate(batch_iter):
        if c % num_processes == process_id:
            yield c, n_processed, batch
        n_processed += len(batch)


@dataclass
class ShardWriter:
    """Per-rank SAM shard: MAGIC, then length-prefixed (chunk_idx,
    sam-bytes) records.  Self-describing, so the merge needs no sidecar
    index."""
    path: str

    def __post_init__(self):
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)

    def add_chunk(self, chunk_idx: int, sam_text: str) -> None:
        data = sam_text.encode()
        self._f.write(struct.pack("<qq", chunk_idx, len(data)))
        self._f.write(data)

    def close(self) -> None:
        self._f.close()


def read_shard(path: str) -> Iterator[tuple[int, bytes]]:
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a bwamem shard file")
        while True:
            hdr = f.read(16)
            if not hdr:
                return
            c, n = struct.unpack("<qq", hdr)
            yield c, f.read(n)


def merge_shards(shard_paths: list[str], out) -> int:
    """Ordered merge: interleave per-chunk records by chunk index (the
    reference's ordered minibatch writer) into the binary stream `out`.
    Returns chunks written; raises ValueError when a chunk is missing."""
    iters = [read_shard(p) for p in shard_paths]
    heads = [next(it, None) for it in iters]
    written = 0
    expect = 0
    while any(h is not None for h in heads):
        for i, h in enumerate(heads):
            if h is not None and h[0] == expect:
                out.write(h[1])
                heads[i] = next(iters[i], None)
                written += 1
                expect += 1
                break
        else:
            raise ValueError(f"shard merge: chunk {expect} missing "
                             f"(heads: {[h and h[0] for h in heads]})")
    return written


def align_shard(al, batch_iter, *, process_id: int, num_processes: int,
                shard_path: str, pe: bool = False,
                rg_id: str | None = None) -> int:
    """Drive this rank's chunks through the local Aligner and write the
    SAM shard.  Returns reads aligned on this rank.  As in the reference,
    no -I insert-size spec reaches the chunks: each infers its own."""
    w = ShardWriter(shard_path)
    done = 0
    try:
        # chunk offsets are replayed explicitly per chunk (they are not
        # contiguous on one rank)
        for cidx, n_proc, batch in shard_chunks(batch_iter, process_id,
                                                num_processes, pe=pe):
            if pe:
                sams = al.align_batch_pe(batch, n_proc, rg_id=rg_id)
            else:
                sams = al.align_batch_se(batch, n_proc, rg_id=rg_id)
            w.add_chunk(cidx, "".join(sams))
            done += len(batch)
    finally:
        w.close()
    return done
