"""Failure detection and restart for render jobs (the port of
distributed_raytracer_tpu/utils/supervise.py).

The unit of recovery is the render process and the unit of state is the
atomically saved sample batch (render/progressive.py): the supervisor
spawns the port's render CLI as a child and watches for

  - death (any nonzero exit, SIGKILL included), and
  - stalls (a heartbeat file that the child writes every progress step
    going quiet for `stall_timeout` seconds),

kills the exact child pid on a stall (never by pattern) and restarts it up
to `max_restarts` times; the child resumes from its checkpoint, and a
resumed render is bit-identical to an uninterrupted one.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SuperviseResult:
    exit_code: int
    restarts: int
    events: List[str] = field(default_factory=list)


class Supervisor:
    """Run `python -m distributed_raytracer_tpu_torch.cli <argv>` under
    failure detection.

    argv should include `--checkpoint` (otherwise a restart recomputes
    from scratch — legal, but the supervisor warns) and, when stall
    detection is wanted, `--heartbeat <path>` matching `heartbeat`."""

    def __init__(
        self,
        argv: List[str],
        heartbeat: Optional[str] = None,
        stall_timeout: Optional[float] = None,
        max_restarts: int = 5,
        poll: float = 0.2,
        startup_grace: Optional[float] = None,
        log=None,
    ):
        self.argv = list(argv)
        self.heartbeat = heartbeat
        self.stall_timeout = stall_timeout
        self.max_restarts = max_restarts
        self.poll = poll
        # Until an attempt's first beat the child is starting up (the torch
        # import, the CUDA context, the kernels' build), not looping: judge
        # it by a longer window so a slow start is not killed as a stall.
        # After the first beat the strict stall_timeout applies.
        self.startup_grace = (
            startup_grace
            if startup_grace is not None
            else (stall_timeout * 4 if stall_timeout is not None else None)
        )
        self._log = log or (lambda msg: print(f"[supervise] {msg}", file=sys.stderr))
        if stall_timeout is not None and heartbeat is None:
            raise ValueError("stall_timeout requires a heartbeat path")
        if "--checkpoint" not in argv:
            self._log("WARNING: no --checkpoint in child args; a restart "
                      "will start the render over")

    def _spawn(self) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", *self.argv],
            env=dict(os.environ),
        )

    def _hb_age(self, started: float) -> tuple:
        """(age_seconds, beaten): age since the last beat of THIS attempt
        (or since child start when it hasn't beaten yet), and whether a
        beat has been seen this attempt.  A beat left over from a PREVIOUS
        attempt must not count for or against this child."""
        try:
            ref = os.path.getmtime(self.heartbeat)
        except OSError:
            ref = started  # no beat yet: measure from child start
        beaten = ref > started
        return time.time() - max(ref, started), beaten

    def run(self) -> SuperviseResult:
        restarts = 0
        events: List[str] = []
        while True:
            started = time.time()
            child = self._spawn()
            self._log(f"child pid {child.pid} (attempt {restarts + 1})")
            stalled = False
            while True:
                rc = child.poll()
                if rc is not None:
                    break
                if self.stall_timeout is not None:
                    age, beaten = self._hb_age(started)
                    limit = self.stall_timeout if beaten else self.startup_grace
                    if age > limit:
                        stalled = True
                        self._log(
                            f"heartbeat stalled > {limit}s"
                            f"{'' if beaten else ' (startup)'}; "
                            f"killing pid {child.pid}"
                        )
                        child.send_signal(signal.SIGKILL)
                        child.wait()
                        rc = child.returncode
                        break
                time.sleep(self.poll)
            if rc == 0 and not stalled:
                events.append("ok")
                return SuperviseResult(0, restarts, events)
            events.append("stall" if stalled else f"exit:{rc}")
            if restarts >= self.max_restarts:
                self._log(f"giving up after {restarts} restarts (rc={rc})")
                return SuperviseResult(rc if rc else 1, restarts, events)
            restarts += 1
            self._log(f"child failed ({events[-1]}); restarting")
