"""Legacy short-read aligner (`aln` / `samse` / `sampe`) — the bounded-diff
backtracking search family the reference exposes next to `mem`
(main.c:111-113).  The search and the SAM rendering run on the host; the
FM lookups, SA walks and the banded SWs run on the caller's device."""
