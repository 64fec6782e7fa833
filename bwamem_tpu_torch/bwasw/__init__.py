"""BWA-SW long-read aligner (the reference's `bwasw` command).

Reimplements the prefix-DAG × prefix-trie dynamic programming of
bwtsw2_core.c plus the per-read loop around it (bwtsw2_aux.c), chain filter
(bwtsw2_chain.c) and read pairing (bwtsw2_pair.c).  The irregular beam
traversal is host code (it is inherently sequential pointer-chasing, single
CPU thread per read in the reference too); the dense compute — SW
extensions (the one-pass extension kernel on a card), global-alignment
CIGARs, SA walks and pair-rescue local SW — runs batched on the device.
Counterpart of bwamem_tpu/bwasw; its SAM bytes are the JAX package's."""
from bwamem_tpu_torch.bwasw.aux import Bsw2Options, bsw2_aln

__all__ = ["Bsw2Options", "bsw2_aln"]
