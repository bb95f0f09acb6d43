"""Device-owner thread with stall detection.

Every device dispatch-or-fetch section runs as a closure on ONE daemon
worker thread (the analog of the reference's dedicated send/recv threads
owning the FPGA, fpga_chaindp.c:83/228), and the submitting thread waits
with a timeout.  On timeout the device is marked bad for the rest of the
process and the caller gets DeviceStall, which ends the run with that
error: a device that stopped answering is a failure, not a reason to map
on the host instead.  The one worker thread also serializes all device
access from the pipeline's threads.

Timeout: MM2TPU_DEVICE_TIMEOUT_S (default 180 s — generous enough for a
kernel compile queued behind another section).  Call sites pass
timeout=None on the CPU backend, which bypasses the worker thread entirely
(jax CPU is thread-safe and never stalls).
"""
from __future__ import annotations

import os
import queue
import sys
import threading


class DeviceStall(RuntimeError):
    """A device call exceeded its timeout (or the device was already
    marked bad)."""


DEFAULT_TIMEOUT_S = float(os.environ.get("MM2TPU_DEVICE_TIMEOUT_S", "180"))
# budget for a dispatch whose static key is COLD (first compile in this
# process with a cold persistent cache)
COMPILE_TIMEOUT_S = float(os.environ.get("MM2TPU_COMPILE_TIMEOUT_S", "600"))

_q: queue.SimpleQueue | None = None
_started = False
_bad = False
_start_lock = threading.Lock()
# sequences the waiter's timeout/abandon decision against the worker's
# completion (an unlocked handoff could permanently ban a device whose
# call finished exactly at the timeout boundary)
_ban_lock = threading.Lock()


def device_bad() -> bool:
    return _bad


# CPU seconds the device-owner thread has consumed executing submitted
# sections (dispatch marshalling, PJRT polling, blocking-fetch CPU). The
# steal lane's economics (models/steal.py) charge this to the device
# lane: it is CPU taken from the host mapping lane.
# PJRT-internal transfer threads are invisible here — an undercount the
# guard's margin absorbs. Reads are approximate (no lock; float add).
_owner_cpu = [0.0]


def owner_cpu_s() -> float:
    return _owner_cpu[0]


_exit_hook_armed = False


def _arm_exit_hook():
    """Once the worker thread is wedged inside a stalled PJRT call, normal
    interpreter teardown (jax's atexit backend destruction, daemon-thread
    finalization) unwinds the wedged C++ frame and glibc aborts with
    SIGABRT — AFTER all output was produced.  Arm an atexit hook that
    flushes and hard-exits first.  atexit runs LIFO, so this hook
    (registered at stall time, i.e. late) preempts jax's own teardown.
    Callers that need a nonzero status must exit through their own path
    before atexit (the CLI does: cli._exit) — and an uncaught exception
    is remembered via sys.excepthook so the hard exit reports failure
    instead of masking it with status 0."""
    global _exit_hook_armed
    if _exit_hook_armed:
        return
    _exit_hook_armed = True
    import atexit
    failed = []
    prev_hook = sys.excepthook

    def _remember(tp, val, tb):
        failed.append(1)
        prev_hook(tp, val, tb)

    sys.excepthook = _remember

    def _hard_exit():
        if not _bad:
            return  # worker recovered — normal teardown is safe
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1 if failed else 0)

    atexit.register(_hard_exit)


class _Call:
    __slots__ = ("fn", "status", "value", "ev", "abandoned")

    def __init__(self, fn):
        self.fn = fn
        self.status = None
        self.value = None
        self.ev = threading.Event()
        self.abandoned = False  # waiter timed out before completion


_owner_tid = [0]


def set_owner_nice(n: int) -> None:
    """Re-prioritize the device-owner thread (models/steal.py: a lane
    whose measured economics PAY competes at equal priority; an unproven
    or losing lane yields the core to the host mapping lane)."""
    try:
        if _owner_tid[0]:
            os.setpriority(os.PRIO_PROCESS, _owner_tid[0], n)
    except Exception:
        pass


def _worker():
    global _bad
    # deprioritize the device-owner thread (Linux per-thread nice): a
    # blocking PJRT call can busy-poll, which steals CPU from the host
    # mapping lane. When the host lane is idle (pure-device phases) the
    # worker still gets the core; under contention the host lane wins.
    # MM2TPU_DEVICE_NICE=0 disables.
    _owner_tid[0] = threading.get_native_id()
    try:
        nice = int(os.environ.get("MM2TPU_DEVICE_NICE", "10"))
        if nice:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), nice)
    except Exception:
        pass
    import time as _time
    while True:
        call = _q.get()
        t0 = _time.thread_time()
        try:
            call.value = call.fn()
            call.status = "ok"
        except BaseException as e:  # noqa: BLE001 — relayed to the waiter
            call.value = e
            call.status = "err"
        _owner_cpu[0] += _time.thread_time() - t0
        with _ban_lock:   # sequenced against the waiter's abandon path
            if call.abandoned and call.status == "ok" and _bad:
                # the waiter gave up on THIS call but the device came back
                # (a long first compile, not a wedge) — un-ban it so the
                # next batch routes to the device again
                _bad = False
                print("[mm2tpu] device recovered (slow call completed)",
                      file=sys.stderr)
            call.ev.set()


def device_call(fn, timeout: float | None = DEFAULT_TIMEOUT_S):
    """Run fn() on the device-owner thread and wait up to `timeout` seconds.

    timeout=None runs fn() directly on the calling thread (CPU backend).
    Raises DeviceStall if the device was already marked bad or the wait
    times out.  A timed-out call may still complete later on the worker
    thread — if it does, the ban is lifted (see _worker); a genuinely
    wedged call keeps the device bad and no further work is submitted."""
    global _bad, _started, _q
    if timeout is None:
        return fn()
    if _bad:
        raise DeviceStall("device previously marked unavailable")
    with _start_lock:
        if not _started:
            _q = queue.SimpleQueue()
            threading.Thread(target=_worker, daemon=True,
                             name="mm2tpu-device").start()
            _started = True
    call = _Call(fn)
    _q.put(call)
    # wait in short slices: a call queued BEHIND a wedged one must bail as
    # soon as another thread bans the device, not sleep its whole budget
    import time as _time
    deadline = _time.monotonic() + timeout
    done = call.ev.wait(min(timeout, 2.0))
    while not done:
        if _bad and not call.ev.is_set():
            raise DeviceStall("device marked unavailable while queued")
        rem = deadline - _time.monotonic()
        if rem <= 0:
            break
        done = call.ev.wait(min(rem, 2.0))
    if not done:
        with _ban_lock:   # sequenced against the worker's completion
            if not call.ev.is_set():
                call.abandoned = True
                _bad = True
                _arm_exit_hook()
                print(f"[mm2tpu] ERROR: device stalled >{timeout:.0f}s",
                      file=sys.stderr)
                raise DeviceStall(f"device call exceeded {timeout:.0f}s")
    if call.status == "err":
        raise call.value
    return call.value
