"""The processes of a run: starting, reading and stopping them.

Every child runs under ``python -X importtime`` with its standard error in
a log under the run's directory, so that after the run the harness can
name every module each child imported (``imported``), the program's
processes included, without touching how they start.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

from portbench.spec import ROOT

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpu_pod_exporter"})


def forbidden(names) -> list[str]:
    """Modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def imported(log: Path) -> set[str]:
    """The modules a child imported, from its ``-X importtime`` lines."""
    out = set()
    for line in log.read_text(errors="replace").splitlines():
        if line.startswith("import time:") and "|" in line:
            name = line.rsplit("|", 1)[1].strip()
            if name and name != "imported package":
                out.add(name)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(extra: dict[str, str] | None = None) -> dict[str, str]:
    """The run's environment with the program's own settings cleared: no
    ``TPE_*`` fallback and no TPU identity variable leaks into a child. The
    string hash seed is fixed, so that the layout of every dict and set, and
    with it the time they take, is the same from run to run."""
    drop = ("TPE_", "TPU_", "MEGASCALE_")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(drop) and k not in ("ACCELERATOR_TYPE", "WORKER_ID", "NODE_NAME")}
    env["USE_FLAX"] = "0"
    env["PYTHONHASHSEED"] = "0"
    env.update(extra or {})
    return env


class Child:
    """A child process speaking JSON lines on its standard output."""

    def __init__(self, argv: list[str], log: Path, env: dict[str, str] | None = None,
                 protocol: bool = True) -> None:
        self.log = log
        with open(log, "wb") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-X", "importtime", *argv], cwd=ROOT,
                env=child_env(env), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE if protocol else err, stderr=err)
        self._lines: queue.Queue = queue.Queue()
        if protocol:
            threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for raw in self.proc.stdout:
            self._lines.put(raw.decode(errors="replace"))
        self._lines.put(None)

    def expect(self, key: str, timeout: float) -> dict:
        """The next JSON line that carries ``key``."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"{self.log.name}: no {key!r} line in {timeout:.0f} s")
            if line is None:
                raise RuntimeError(f"{self.log.name}: exited {self.proc.wait()} before {key!r}:\n"
                                   + self.log.read_text(errors="replace")[-3000:])
            if line.startswith("{"):
                doc = json.loads(line)
                if key in doc:
                    return doc

    def send(self, command: str) -> None:
        self.proc.stdin.write((command + "\n").encode())
        self.proc.stdin.flush()

    def close(self, timeout: float = 60.0) -> int:
        """End the child: close its input, then SIGTERM, then SIGKILL."""
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                return self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pass
        return stop(self.proc)


def stop(proc: subprocess.Popen, timeout: float = 20.0) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
    return proc.wait()


def http_get(url: str, timeout: float = 10.0) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310 — localhost
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError:
        return 0, b""


def wait_for(check, timeout: float, what: str, proc: subprocess.Popen | None = None,
             log: Path | None = None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = check()
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            break
        time.sleep(0.1)
    tail = log.read_text(errors="replace")[-3000:] if log is not None else ""
    raise RuntimeError(f"timed out waiting for {what}\n{tail}")


def cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of a process and its threads, from
    ``/proc/<pid>/stat`` (fields 14 and 15, in clock ticks)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def thread_cpu(pid: int) -> dict[str, float]:
    """User + system CPU seconds of each live thread of a process, by
    thread id, from ``/proc/<pid>/task/<tid>/stat``."""
    out: dict[str, float] = {}
    tick = os.sysconf("SC_CLK_TCK")
    for task in Path(f"/proc/{pid}/task").iterdir():
        try:
            fields = (task / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue    # the thread ended
        out[task.name] = (int(fields[11]) + int(fields[12])) / tick
    return out
