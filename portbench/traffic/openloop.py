"""An open loop of HTTP GETs at a fixed rate over keep-alive connections.

Arrivals are Poisson in shape but fixed in number: a run of ``seconds``
at ``rate`` sends ``round(rate * seconds)`` requests, whose gaps are the
quantiles of the exponential distribution, shuffled by the seed. Every
seed sends the same set of gaps in another order, so the seed moves no
work. One thread runs the loop over a ``selectors`` poll: it hands each
request, at its due instant, to a free connection, or queues it until
one is free, as a scraper's queue would; no other thread shares its
interpreter. Each request is timed from its due instant to its last
byte: a stall delays the requests behind it, and they count the wait.

Run as a module it is the node cells' client, in a process of its own:

    python -m portbench.traffic.openloop SPEC OUT

reads the JSON file ``SPEC`` (the target, the traffic's parameters, the
seed, the window's seconds, the program's pid, the sample that stamps an
answer), warms the path, prints ``{"ready": ...}``, waits for a line on
standard input, runs the window, reads the program's CPU from ``/proc`` at
the window's two ends, writes every request's timings, every answer's
stamp and the sampled answers to the JSON file ``OUT`` and prints
``{"done": ...}``.
"""

from __future__ import annotations

import collections
import gzip
import json
import math
import random
import selectors
import socket
import sys
import time
from dataclasses import dataclass


def due_instants(rate: float, seconds: float, seed: int) -> list[float]:
    """Offsets in ``[0, seconds)`` of the requests a run sends."""
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / (n + 1)) for i in range(n + 1)]
    random.Random(seed).shuffle(gaps)
    scale = seconds / sum(gaps)
    out, t = [], 0.0
    for g in gaps[:n]:
        t += g * scale
        out.append(t)
    return out


def judged(n: int, count: int, seed: int) -> set[int]:
    """The requests whose answers are judged: ``count`` drawn from the
    seed, and the last."""
    keep = set(random.Random(f"judge-{seed}").sample(range(n), min(count, n)))
    keep.add(n - 1)
    return keep


@dataclass
class Result:
    due: float          # offset of the due instant from the window's start
    sent: float         # offset at which a connection took it
    done: float         # offset of its last byte, or of its failure
    status: int         # HTTP status; 0 for a transport failure
    received_wall: float = 0.0
    body: bytes | None = None   # kept only for sampled requests


class Connection:
    """One keep-alive HTTP/1.1 connection over a plain socket: the request
    is encoded once, and a response is read by its Content-Length, so the
    client spends as little of its interpreter's time as it can."""

    def __init__(self, host: str, port: int, path: str, headers: dict[str, str],
                 timeout_s: float) -> None:
        lines = [f"GET {path} HTTP/1.1", f"Host: {host}:{port}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        self.request = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        self.addr, self.timeout_s = (host, port), timeout_s
        self.sock: socket.socket | None = None
        self.buf = b""
        self.closing = False    # the server closes after this response

    def send(self) -> socket.socket:
        """Send the request, connecting first where no connection is open;
        raises OSError on a transport failure."""
        try:
            if self.sock is None:
                self.sock = socket.create_connection(self.addr, timeout=self.timeout_s)
            self.buf = b""
            self.sock.sendall(self.request)
            return self.sock
        except OSError:
            self.close()
            raise

    def feed(self) -> tuple[int, bytes] | None:
        """Read what has arrived: ``(status, body)`` once the response is
        whole, else None; raises OSError on a transport failure. The
        caller closes the connection after a failure or when ``closing``."""
        try:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("closed inside the response")
            self.buf += chunk
            end = self.buf.find(b"\r\n\r\n")
            if end < 0:
                return None
            fields = self.buf[:end].lower().split(b"\r\n")
            status = int(fields[0].split(b" ", 2)[1])
            length = next((int(f.split(b":", 1)[1]) for f in fields[1:]
                           if f.startswith(b"content-length:")), 0)
            body = self.buf[end + 4:]
            if len(body) < length:
                return None
        except (OSError, ValueError, IndexError):
            raise OSError("transport failure")
        self.closing = b"connection: close" in fields
        return status, body[:length]

    def get(self) -> tuple[int, bytes]:
        """One whole request, waiting for its answer."""
        self.send()
        try:
            while True:
                got = self.feed()
                if got is not None:
                    break
        except OSError:
            self.close()
            raise
        if self.closing:
            self.close()
        return got

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None


class OpenLoop:
    """``connections`` keep-alive connections to one path; ``keep`` holds
    the indices of the requests whose bodies are kept."""

    def __init__(self, host: str, port: int, path: str, headers: dict[str, str],
                 connections: int, keep: set[int] | None = None,
                 timeout_s: float = 30.0) -> None:
        self.conns = [Connection(host, port, path, headers, timeout_s)
                      for _ in range(connections)]
        self.keep, self.timeout_s = keep or set(), timeout_s

    def run(self, dues: list[float], start: float, at=None) -> list[Result]:
        """Send request ``k`` at ``start + dues[k]`` (``time.perf_counter``).
        ``at = (offset, fn)`` calls ``fn()`` once at ``start + offset``,
        from the loop, while requests are out or after the last answer."""
        sel = selectors.DefaultSelector()
        idle = collections.deque(self.conns)
        queued: collections.deque = collections.deque()
        out: dict[int, tuple] = {}           # connection id -> (k, sent)
        results: list[Result | None] = [None] * len(dues)
        nxt = 0

        def finish(conn: Connection, k: int, sent: float, status: int, body) -> None:
            done = time.perf_counter() - start
            results[k] = Result(dues[k], sent, done, status, time.time(),
                                body if k in self.keep and status == 200 else None)
            idle.append(conn)

        while nxt < len(dues) or queued or out:
            now = time.perf_counter() - start
            if at is not None and now >= at[0]:
                at[1]()
                at = None
            while nxt < len(dues) and dues[nxt] <= now:
                queued.append(nxt)
                nxt += 1
            while queued and idle:
                conn, k = idle.popleft(), queued.popleft()
                sent = time.perf_counter() - start
                try:
                    sel.register(conn.send(), selectors.EVENT_READ, conn)
                    out[id(conn)] = (k, sent)
                except OSError:
                    finish(conn, k, sent, 0, None)
            wake = [dues[nxt]] if nxt < len(dues) else []
            if at is not None:
                wake.append(at[0])
            wake += [sent + self.timeout_s for _k, sent in out.values()]
            timeout = max(0.0, min(wake) - (time.perf_counter() - start)) if wake else 0.0
            if not out:
                time.sleep(timeout)
                continue
            for key, _mask in sel.select(timeout):
                conn = key.data
                k, sent = out[id(conn)]
                try:
                    got = conn.feed()
                except OSError:
                    got, conn.closing = (0, None), True
                if got is None:
                    continue
                sel.unregister(conn.sock)
                if conn.closing:
                    conn.close()
                del out[id(conn)]
                finish(conn, k, sent, *got)
            late = time.perf_counter() - start - self.timeout_s
            for conn in [c for c in self.conns if id(c) in out and out[id(c)][1] < late]:
                k, sent = out.pop(id(conn))
                sel.unregister(conn.sock)
                conn.close()
                finish(conn, k, sent, 0, None)
        if at is not None:
            time.sleep(max(0.0, start + at[0] - time.perf_counter()))
            at[1]()
        for conn in self.conns:
            conn.close()
        sel.close()
        return [r for r in results if r is not None]


def warm(host: str, port: int, path: str, headers: dict[str, str], count: int) -> None:
    """``count`` requests on one connection, before the window."""
    conn = Connection(host, port, path, headers, 30.0)
    try:
        for _ in range(count):
            conn.get()
    finally:
        conn.close()


def stamp_of(text: str, name: str) -> float | None:
    """The value of the unlabelled sample ``name`` in an exposition."""
    at = text.find("\n" + name + " ")
    if at < 0:
        return None
    line = text[at + len(name) + 2:text.find("\n", at + 1)]
    return float(line.split()[0])


def main(argv: list[str]) -> int:
    from portbench import procs

    with open(argv[0]) as f:
        spec = json.load(f)
    mix, host, port, pid = spec["traffic"], spec["host"], spec["port"], spec["pid"]
    headers = dict(mix["headers"])
    warm(host, port, mix["path"], headers, mix["warm_requests"])
    time.sleep(mix["settle_s"])
    dues = due_instants(mix["rate_per_s"], spec["seconds"], spec["seed"])
    judge = judged(len(dues), mix["judged_answers"], spec["seed"])
    # Every body is kept through the window (a reference to bytes already
    # read, no work a request); after it, each one's ``spec["stamp"]`` is
    # read, and the judged ones are written whole.
    loop = OpenLoop(host, port, mix["path"], headers, mix["connections"], set(range(len(dues))))
    print(json.dumps({"ready": True, "requests": len(dues)}), flush=True)
    sys.stdin.readline()
    cpu = {"start": procs.cpu_seconds(pid), "threads_start": procs.thread_cpu(pid)}

    def window_end() -> None:
        cpu["end"], cpu["threads_end"] = procs.cpu_seconds(pid), procs.thread_cpu(pid)

    start = time.perf_counter()
    results = loop.run(dues, start, (spec["seconds"], window_end))
    stamps, bodies = [], []
    judged_dues = {dues[k] for k in judge}
    for r in results:
        if r.body is None:
            continue
        text = gzip.decompress(r.body).decode()
        stamps.append([r.received_wall, stamp_of(text, spec["stamp"])])
        if r.due in judged_dues:
            bodies.append([r.received_wall, text])
    with open(argv[1], "w") as f:
        json.dump({
            "attempted": len(dues), "cpu": cpu, "stamps": stamps, "bodies": bodies,
            "results": [[r.due, r.sent, r.done, r.status, r.received_wall] for r in results]}, f)
    print(json.dumps({"done": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
