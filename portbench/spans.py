"""Host spans of a traced run, taken from the benchmark's side.

`Recorder.install()` wraps, for the length of the window:
- the program's stage timers (utils/timers `section`, `start`/`stop`), so
  that every stage it already names also leaves a timestamped span;
- the device front's two calls (`device_front.front_start`,
  `front_finish`) and the host-compacted front
  (`Aligner._regs_host_front`), as spans of the benchmark's own;
- kernel #1's launch (`ops/ext_kernel.launch_pl2`), keeping copies of
  each call's lane lengths for its roofline.
`uninstall()` puts every original back.  Spans are (name, start_ns,
end_ns) on time.time_ns's clock, the device trace's.
"""
from __future__ import annotations

import contextlib
import time


def _now() -> int:
    return time.time_ns()


class Recorder:
    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []
        self.ext_calls: list[dict] = []
        self._undo: list[tuple[object, str, object]] = []

    def span(self, name: str):
        @contextlib.contextmanager
        def run():
            t0 = _now()
            try:
                yield
            finally:
                self.spans.append((name, t0, _now()))
        return run()

    def _patch(self, owner, attr: str, new) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def _wrap(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            with self.span(name):
                return orig(*a, **k)
        self._patch(owner, attr, wrapped)

    def install(self) -> None:
        from bwamem_tpu_torch.ops import ext_kernel
        from bwamem_tpu_torch.pipeline import align, device_front
        from bwamem_tpu_torch.utils import timers
        timers.enable(True)
        timers.reset()
        sec, start, stop = timers.section, timers.start, timers.stop
        rec = self

        def section(name):
            inner = sec(name)

            @contextlib.contextmanager
            def run():
                t0 = _now()
                try:
                    with inner:
                        yield
                finally:
                    rec.spans.append((name, t0, _now()))
            return run()

        def t_start(name):
            return (start(name), _now())

        def t_stop(name, tok):
            if tok is None:
                return
            stop(name, tok[0])
            rec.spans.append((name, tok[1], _now()))
        self._patch(timers, "section", section)
        self._patch(timers, "start", t_start)
        self._patch(timers, "stop", t_stop)
        self._wrap(device_front, "front_start", "front_start")
        self._wrap(device_front, "front_finish", "front_finish")
        self._wrap(align.Aligner, "_regs_host_front", "host_front")
        launch = ext_kernel.launch_pl2

        def launch_pl2(queryT, qlen, targetT, tlen, h0, end_bonus, p, **kw):
            res, retried = launch(queryT, qlen, targetT, tlen, h0, end_bonus,
                                  p, **kw)
            rec.ext_calls.append(dict(
                qlen=qlen.clone(), tlen=tlen.clone(), eb=end_bonus.clone(),
                retried=retried.clone(), kw=kw))
            return res, retried
        self._patch(ext_kernel, "launch_pl2", launch_pl2)

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def totals(self) -> dict[str, float]:
        """Seconds by span name."""
        out: dict[str, float] = {}
        for n, s, e in self.spans:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out
