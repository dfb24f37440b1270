"""Observability: phase timers, throughput reporting, profiler traces.

The reference instruments with ad-hoc ``std::time::Instant`` spans
(``/root/reference/src/alignment/algo.rs:188,270-277``,
``tree.rs:103-132``, ``main.rs:250-326``). The equivalents here:

* :class:`PhaseTimer` — nested wall-clock spans with cell/throughput
  annotations, logged in the reference's "Time taken to ..." style;
* :func:`trace` — a ``jax.profiler`` trace context gated by
  ``GENOMICS_TPU_TRACE=<dir>`` (produces TensorBoard-compatible
  traces of the device timeline);
* :func:`annotate` — ``jax.profiler.TraceAnnotation`` wrapper so
  phases show up inside device traces.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

log = logging.getLogger(__name__)


class PhaseTimer:
    """Wall-clock phase timer with optional work-unit throughput.

    >>> t = PhaseTimer("fill")
    >>> with t.span("dp", cells=9e8):
    ...     ...
    fill/dp logs "Time taken to dp: ... us (... ms), 1.2e10 cells/s"
    """

    def __init__(self, name: str):
        self.name = name
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, phase: str, cells: float | None = None):
        t0 = time.perf_counter()
        try:
            with annotate(f"{self.name}/{phase}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[phase] = self.spans.get(phase, 0.0) + dt
            extra = f", {cells / dt:.3g} cells/s" if cells else ""
            log.info(
                "[%s] Time taken to %s: %d us (%d ms)%s",
                self.name,
                phase,
                int(dt * 1e6),
                int(dt * 1e3),
                extra,
            )

    def total(self) -> float:
        return sum(self.spans.values())


@contextlib.contextmanager
def spinner(message: str, done: str):
    """Terminal spinner parity with the reference's spinoff usage
    (``/root/reference/src/alignment/algo.rs:181-185,292-296``):
    animated only on a TTY, replaced by the success message when the
    block completes."""
    import sys
    import threading

    tty = sys.stderr.isatty()
    stop = threading.Event()

    def spin():
        frames = "⠋⠙⠹⠸⠼⠴⠦⠧⠇⠏"
        i = 0
        while not stop.is_set():
            sys.stderr.write(f"\r{frames[i % len(frames)]} {message}")
            sys.stderr.flush()
            i += 1
            stop.wait(0.1)

    t = None
    if tty:
        t = threading.Thread(target=spin, daemon=True)
        t.start()
    ok = False
    try:
        yield
        ok = True
    finally:
        if t is not None:
            stop.set()
            t.join(timeout=1)
            if ok:
                sys.stderr.write(f"\r\x1b[K✓ {done}\n")
            else:
                sys.stderr.write(f"\r\x1b[K✗ {message}\n")
            sys.stderr.flush()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a device profiler trace (no-op off-trace).

    Only the *construction* of the annotation is guarded: wrapping the
    ``yield`` itself in an except that yields again would swallow any
    exception raised inside the annotated block and violate the
    generator-contextmanager protocol ("generator didn't stop after
    throw()"), losing the original error."""
    try:
        import jax.profiler

        ctx = jax.profiler.TraceAnnotation(name)
    except Exception:  # noqa: BLE001 — profiling must never break runs
        ctx = contextlib.nullcontext()
    with ctx:
        yield


@contextlib.contextmanager
def trace(name: str = "genomics"):
    """Capture a jax.profiler device trace when GENOMICS_TPU_TRACE is
    set to an output directory."""
    trace_dir = os.environ.get("GENOMICS_TPU_TRACE")
    if not trace_dir:
        yield
        return
    import jax.profiler

    out = os.path.join(trace_dir, name)
    os.makedirs(out, exist_ok=True)
    log.info("profiler trace -> %s", out)
    with jax.profiler.trace(out):
        yield
