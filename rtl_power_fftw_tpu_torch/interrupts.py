"""Graceful-stop state machine: SIGINT escalation.

Mirrors the reference's src/interrupts.{h,cxx}: the first Ctrl+C finishes
the current pass, the second stops acquisition as soon as possible, and the
third is left to the default handler (killing the process) because the
custom handler uninstalls itself at level two (interrupts.cxx:28-31).
"""

from __future__ import annotations

import enum
import signal
import sys
import threading


class InterruptState(enum.IntEnum):
    Neutral = 0
    FinishPass = 1
    FinishNow = 2


# The LEVEL counter is lock-free on purpose, mirroring the reference's
# std::atomic counter (interrupts.cxx:25): CPython delivers signal
# handlers on the main thread between bytecodes, so a handler that took a
# lock also held by main-thread code would deadlock the process. The
# handler is the only writer (single increment); readers see a plain int.
# The REPORTING bookkeeping, however, is polled concurrently from every
# producer thread (multistream) — its read-modify-write takes a lock the
# handler never touches, so each level prints exactly once
# (interrupts.cxx:45-60) without any deadlock risk.
_interrupts = 0
_reported = 0
_report_lock = threading.Lock()


def _handler(signum, frame):
    global _interrupts
    _interrupts += 1
    if _interrupts == int(InterruptState.FinishNow):
        set_ctrl_c_handler(False)


def set_ctrl_c_handler(install: bool) -> None:
    """Install/uninstall the SIGINT handler (interrupts.cxx:33-43).

    Real SIGINT delivery always runs the handler on the main thread;
    test/fault-injection harnesses may escalate programmatically from a
    worker thread, where CPython forbids signal.signal — the escalation
    COUNT is what matters (the session polls it), so a non-main-thread
    UNINSTALL is a no-op rather than an error. A failed INSTALL still
    raises: silently running without the handler would lose the
    graceful finish-this-pass semantics on a real Ctrl-C."""
    try:
        signal.signal(signal.SIGINT,
                      _handler if install else signal.SIG_DFL)
    except ValueError:  # not the main thread (harness-simulated Ctrl-C)
        if install:
            raise


def reset() -> None:
    """Clear state (test support; the reference process never needs this)."""
    global _interrupts, _reported
    _interrupts = 0
    _reported = 0


def raise_interrupt() -> None:
    """Programmatic escalation (test/fault-injection support)."""
    _handler(signal.SIGINT, None)


def check_interrupt(check_level: InterruptState, stderr=None) -> bool:
    """Poll the interrupt level; print each newly observed level once
    (interrupts.cxx:45-60)."""
    global _reported
    err = stderr if stderr is not None else sys.stderr
    current = _interrupts
    if _reported < current:  # cheap racy pre-check; settled under lock
        with _report_lock:
            while _reported < current:
                _reported += 1
                if _reported == int(InterruptState.FinishPass):
                    print("Interrupted, will try to finish this pass.",
                          file=err)
                elif _reported == int(InterruptState.FinishNow):
                    print("Interrupted, finishing now.", file=err)
    return current >= int(check_level)
