"""Serve frozen node bodies over HTTP, one port a node.

``python -m portbench.traffic.bodyserver DIR`` loads every
``DIR/<host>.<variant>.txt``, listens for each host on a free port of
127.0.0.1, prints ``{"ports": {host: port}}`` and serves ``GET /metrics``
on each until its standard input closes: a host's ``n``-th request gets
its variant ``n`` modulo their number. Then it writes the wall time of
every host's requests, in order, to ``DIR/served.json``, so that the
reference knows which variant each round was served. It stands for the
nodes of a fleet that the card's host does not have. It runs in a process of its own, so that serving takes nothing from
the aggregator's interpreter, and as one thread over a ``selectors`` loop
with every response built in advance (gzip at level 1, as the exporter
compresses), so that a request costs an accept, a read and a write: the
stand-ins add as little time, and as little spread, as they can to the
rounds they serve.
"""

from __future__ import annotations

import gzip
import json
import selectors
import socket
import sys
import time
from pathlib import Path

HEAD = ("HTTP/1.1 200 OK\r\nContent-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
        "{enc}Content-Length: {n}\r\nConnection: close\r\n\r\n")
NOT_FOUND = b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\nConnection: close\r\n\r\n"


def responses(text: bytes) -> tuple[bytes, bytes]:
    """The whole plain and gzip responses for one body."""
    zipped = gzip.compress(text, compresslevel=1)
    return (HEAD.format(enc="", n=len(text)).encode() + text,
            HEAD.format(enc="Content-Encoding: gzip\r\n", n=len(zipped)).encode() + zipped)


def answer(request: bytes, plain: bytes, zipped: bytes) -> bytes:
    head = request.split(b"\r\n\r\n", 1)[0].decode("latin-1")
    line, *fields = head.split("\r\n")
    parts = line.split(" ")
    if len(parts) < 2 or parts[0] != "GET" or parts[1].split("?")[0] != "/metrics":
        return NOT_FOUND
    for f in fields:
        name, _, value = f.partition(":")
        if name.strip().lower() == "accept-encoding" and "gzip" in value.lower():
            return zipped
    return plain


def serve(directory: str, stop_fd: int | None = None) -> None:
    sel = selectors.DefaultSelector()
    bodies: dict[str, list] = {}
    for path in sorted(Path(directory).glob("*.txt"), key=lambda p: p.name.split(".")):
        host, variant = path.stem.rsplit(".", 1)
        bodies.setdefault(host, []).append((int(variant), responses(path.read_bytes())))
    ports, served = {}, {}
    for host, answers in bodies.items():
        lsock = socket.socket()
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(128)
        lsock.setblocking(False)
        served[host] = []
        sel.register(lsock, selectors.EVENT_READ,
                     ("listen", (served[host], [r for _v, r in sorted(answers)])))
        ports[host] = lsock.getsockname()[1]
    if stop_fd is not None:
        sel.register(stop_fd, selectors.EVENT_READ, ("stop", None))
    print(json.dumps({"ports": ports}), flush=True)
    while True:
        for key, _mask in sel.select():
            kind, data = key.data
            if kind == "stop":
                if not sys.stdin.buffer.read1(4096):
                    sel.close()
                    with open(Path(directory) / "served.json", "w") as f:
                        json.dump(served, f)
                    return
            elif kind == "listen":
                try:
                    conn, _ = key.fileobj.accept()
                except BlockingIOError:
                    continue
                conn.setblocking(False)
                sel.register(conn, selectors.EVENT_READ, ("read", [b"", data]))
            elif kind == "read":
                try:
                    chunk = key.fileobj.recv(65536)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    chunk = b""
                if not chunk:
                    sel.unregister(key.fileobj)
                    key.fileobj.close()
                    continue
                data[0] += chunk
                if b"\r\n\r\n" in data[0]:
                    times, answers = data[1]
                    out = answer(data[0], *answers[len(times) % len(answers)])
                    if out is not NOT_FOUND:
                        times.append(time.time())
                    out = memoryview(out)
                    sel.modify(key.fileobj, selectors.EVENT_WRITE, ("write", [out]))
            else:
                try:
                    sent = key.fileobj.send(data[0])
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    sent = len(data[0])
                data[0] = data[0][sent:]
                if not len(data[0]):
                    sel.unregister(key.fileobj)
                    key.fileobj.close()


def main(argv: list[str]) -> int:
    serve(argv[0], sys.stdin.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
