"""Process ↔ device attribution via procfs — the per-process dimension.

The reference's headline capability is *per-process* device accounting: NVML
``GetComputeRunningProcesses`` host PIDs joined against ``kubectl exec … ps``
output (``main.go:101-109,135-154``). That join is broken by construction —
container-namespace PIDs compared against host PIDs, and an index-vs-value
bug besides (SURVEY.md §2.6 items 1-2). On a TPU node the same question —
**which process holds which chip?** — has a correct, purely local answer:
the process that opened ``/dev/accel*`` (or its vfio group) shows the device
in its own ``/proc/<pid>/fd``, host-side, with no exec, no apiserver, and no
PID-namespace translation. The process's cgroup path names the pod UID and
container runtime ID, which cross-checks the kubelet podresources
allocation (the primary attribution source).

Cost model: a full walk of ``/proc`` is O(processes × fds) readlinks, too
much to pay every second on a busy node. The scanner therefore verifies the
cached holder set each call (O(holders) — a handful of processes) and does
a full rescan only every ``full_scan_every`` calls or as soon as a cached
holder changes, so a freed chip disappears within one poll while a *new*
holder appears within ``full_scan_every`` polls.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass

log = logging.getLogger("tpu_pod_exporter_torch.procscan")

# Kubernetes pod UID inside a cgroup path. cgroupfs (v1) spells it with
# dashes (".../kubepods/burstable/pod<uid>/<cid>"); the systemd driver (v2)
# with underscores ("kubepods-burstable-pod<uid>.slice").
_POD_UID_RE = re.compile(
    r"pod([0-9a-f]{8}[-_][0-9a-f]{4}[-_][0-9a-f]{4}[-_][0-9a-f]{4}[-_][0-9a-f]{12})"
)
# Container runtime ID: the path component after the pod scope — hex id,
# optionally wrapped runtime-prefix…"-"…id…".scope" by the systemd driver.
_CONTAINER_ID_RE = re.compile(
    r"^(?:cri-containerd-|docker-|crio-|containerd-)?([0-9a-f]{12,64})(?:\.scope)?$"
)

DEFAULT_DEVICE_PREFIXES = ("/dev/accel", "/dev/vfio/")
# GPU nodes: only /dev/nvidia<minor> is a card. The driver's control nodes
# (/dev/nvidiactl, /dev/nvidia-uvm, /dev/nvidia-uvm-tools,
# /dev/nvidia-modeset, /dev/nvidia-caps/*) share the prefix and are held by
# every CUDA process, so they are matched out (_is_device).
GPU_DEVICE_PREFIXES = ("/dev/nvidia",)
_GPU_NODE_RE = re.compile(r"^/dev/nvidia[0-9]+$")

# The shared vfio *container* node — every vfio-using process holds it open
# (including non-TPU passthrough users), so treating it as a device would
# inflate the holder/verify set on mixed nodes. Only /dev/vfio/<group>
# numeric entries identify an actual passthrough device.
EXCLUDED_DEVICE_PATHS = frozenset({"/dev/vfio/vfio"})


def _is_device(target: str, prefixes: tuple[str, ...]) -> bool:
    """Whether an fd's link target is a device node the scan counts."""
    if not target.startswith(prefixes) or target in EXCLUDED_DEVICE_PATHS:
        return False
    return (not target.startswith(GPU_DEVICE_PREFIXES)
            or _GPU_NODE_RE.match(target) is not None)


class ProcScanError(RuntimeError):
    """The proc root itself was unreadable — the *whole scan* failed (vs. a
    single process racing away, which is normal and silently skipped). Raised
    so the collector's error budget + bounded-staleness holder fallback
    engage instead of publishing a falsely-empty holder set."""


@dataclass(frozen=True)
class DeviceHolder:
    """One (process, device-file) pair: ``pid`` holds ``device_path`` open.

    ``pod_uid``/``container_id`` come from the process's cgroup path and are
    empty for non-pod processes (a bare-metal workload, or the exporter's own
    jax backend when colocated).
    """

    pid: int
    comm: str
    device_path: str
    pod_uid: str = ""
    container_id: str = ""


def parse_cgroup_identity(cgroup_text: str) -> tuple[str, str]:
    """``/proc/<pid>/cgroup`` contents → (pod_uid, container_id), "" when
    the process is not in a Kubernetes pod cgroup. Pure function (the unit
    seam); accepts both cgroupfs-v1 multi-line and v2 single-line formats."""
    for line in cgroup_text.splitlines():
        # line: "<hierarchy>:<controllers>:<path>"
        path = line.rpartition(":")[2]
        m = _POD_UID_RE.search(path)
        if m is None:
            continue
        pod_uid = m.group(1).replace("_", "-")
        container_id = ""
        # The component *after* the pod component names the container.
        tail = path[m.end():].lstrip("-.")  # ".slice/cri-containerd-…" or "/<cid>"
        for comp in tail.split("/"):
            cm = _CONTAINER_ID_RE.match(comp)
            if cm is not None:
                container_id = cm.group(1)
                break
        return pod_uid, container_id
    return "", ""


class ProcScanner:
    """Finds holders of TPU device files by walking procfs.

    ``proc_root`` is injectable so tests drive the scanner over a synthetic
    proc tree (symlinks to nonexistent ``/dev/accel*`` work — only the link
    *target string* is read, never the device).
    """

    name = "procfs"

    def __init__(
        self,
        proc_root: str = "/proc",
        device_prefixes: tuple[str, ...] = DEFAULT_DEVICE_PREFIXES,
        full_scan_every: int = 10,
    ) -> None:
        if full_scan_every < 1:
            raise ValueError("full_scan_every must be >= 1")
        self._proc_root = proc_root
        self._prefixes = device_prefixes
        self._full_scan_every = full_scan_every
        self._cached: dict[int, tuple[DeviceHolder, ...]] = {}
        self._scans_since_full = 0
        # "Empty" is a valid verified result: an idle node must not pay the
        # full /proc walk every poll just because nothing holds a chip.
        self._has_scanned = False
        # Observability for /debug/vars and tests.
        self.full_scans = 0
        self.verify_scans = 0

    # ------------------------------------------------------------------ scan

    def scan(self) -> tuple[DeviceHolder, ...]:
        """Current holder set. Never raises for per-process races (processes
        exiting mid-scan are the norm, not an error)."""
        if self._has_scanned and self._scans_since_full < self._full_scan_every:
            self._scans_since_full += 1
            self.verify_scans += 1
            fresh: dict[int, tuple[DeviceHolder, ...]] = {}
            for pid, prev in self._cached.items():
                now = self._scan_pid(pid)
                if now != prev:
                    # A holder exited or dropped/added a device: the cheap
                    # verify can no longer vouch for the set; rescan now so
                    # a freed chip never reports a stale holder.
                    break
                fresh[pid] = now
            else:
                return self._flatten(fresh)
        return self._full_scan()

    def _full_scan(self) -> tuple[DeviceHolder, ...]:
        found = self._native_full_scan()
        if found is None:
            found = self._python_full_scan()
        self.full_scans += 1
        self._scans_since_full = 0
        self._has_scanned = True
        self._cached = found
        return self._flatten(found)

    def _python_full_scan(self) -> dict[int, tuple[DeviceHolder, ...]]:
        try:
            entries = os.listdir(self._proc_root)
        except OSError as e:
            # Scanner state is left untouched: the failure must not wipe the
            # cache or reset the verify window, or recovery would trust a
            # bogus empty set for another full_scan_every polls.
            raise ProcScanError(f"proc root {self._proc_root!r} unreadable: {e}") from e
        found: dict[int, tuple[DeviceHolder, ...]] = {}
        for entry in entries:
            if not entry.isdigit():
                continue
            pid = int(entry)
            holders = self._scan_pid(pid)
            if holders:
                found[pid] = holders
        return found

    def _native_full_scan(self) -> dict[int, tuple[DeviceHolder, ...]] | None:
        """Walk /proc via libtpumon (the O(processes × fds) readlink loop is
        the scan's entire cost on a busy node). Returns None when the native
        library is unavailable or disagrees structurally — the Python walk is
        always a correct fallback. Per-holder cgroup identity is read here in
        Python: holders are few, the walk is what's hot."""
        from tpu_pod_exporter_torch import nativelib

        lib = nativelib.load()
        if lib is None:
            return None
        if len(self._prefixes) > 16:
            # tpumon_scan_proc matches at most 16 prefixes; beyond that the
            # native scan would silently miss holders — refuse it instead.
            return None
        prefixes = "\n".join(self._prefixes).encode()
        root = self._proc_root.encode()
        cap = 64 * 1024
        import ctypes

        while True:
            buf = ctypes.create_string_buffer(cap)
            n = lib.tpumon_scan_proc(root, prefixes, buf, cap)
            if n < 0:
                if not os.path.isdir(self._proc_root):
                    raise ProcScanError(
                        f"proc root {self._proc_root!r} unreadable"
                    )
                # Readable root but native scan refused: fall back.
                return None
            # Split on '\n' ONLY: splitlines() also breaks on \r/\v/\f/U+0085,
            # which can legally appear inside a comm and would desync the
            # record-count handshake below.
            records = [
                r for r in buf.value.decode("utf-8", errors="replace").split("\n") if r
            ]
            if len(records) == n:
                break
            if cap >= 16 * 1024 * 1024:
                # Still truncated at the ceiling: a partial holder set must
                # not masquerade as the full one (dropped holders would
                # vanish from metrics AND from the verify cache) — let the
                # unbounded Python walk take over.
                return None
            cap *= 4  # truncated: grow and rescan
        by_pid: dict[int, list[str]] = {}
        comms: dict[int, str] = {}
        for rec in records:
            parts = rec.split("\t")
            if len(parts) != 3 or not parts[0].isdigit():
                continue
            if not _is_device(parts[1], self._prefixes):
                # The native walk is a pure prefix matcher; the exclusion
                # rule and the GPU card-node rule live here so Python and
                # native scans agree.
                continue
            pid = int(parts[0])
            by_pid.setdefault(pid, []).append(parts[1])
            comms[pid] = parts[2]
        found: dict[int, tuple[DeviceHolder, ...]] = {}
        for pid, paths in by_pid.items():
            base = os.path.join(self._proc_root, str(pid))
            pod_uid, container_id = parse_cgroup_identity(
                self._read_text(os.path.join(base, "cgroup"))
            )
            found[pid] = tuple(
                DeviceHolder(
                    pid=pid,
                    comm=comms[pid],
                    device_path=dp,
                    pod_uid=pod_uid,
                    container_id=container_id,
                )
                for dp in sorted(set(paths))
            )
        return found

    def _scan_pid(self, pid: int) -> tuple[DeviceHolder, ...]:
        """One process's device-file holds; () on any per-process failure
        (exited, fd table unreadable)."""
        base = os.path.join(self._proc_root, str(pid))
        fd_dir = os.path.join(base, "fd")
        device_paths: list[str] = []
        try:
            for fd in os.listdir(fd_dir):
                try:
                    target = os.readlink(os.path.join(fd_dir, fd))
                except OSError:
                    continue  # fd closed between listdir and readlink
                # A runtime restart can recreate /dev/accel* while a wedged
                # process still holds the old inode; readlink then reports
                # "/dev/accel0 (deleted)". Strip the suffix so the holder
                # still joins to the chip — that wedged holder is exactly
                # what this metric exists to expose.
                if target.endswith(" (deleted)"):
                    target = target[: -len(" (deleted)")]
                if _is_device(target, self._prefixes) and target not in device_paths:
                    device_paths.append(target)
        except OSError:
            return ()
        if not device_paths:
            return ()
        # Sanitized identically to the native scanner's record format (which
        # uses tab/newline separators): parity matters because the verify
        # path compares Python-scanned holders against native-scanned cache
        # entries — any formatting drift would force a full rescan per poll.
        # Trim the explicit ASCII whitespace set (NOT .strip(), which also
        # eats unicode whitespace the C side keeps), then '?'-replace the
        # separators.
        comm = (
            self._read_text(os.path.join(base, "comm"))[:63]
            .strip(" \t\n\r\v\f")
            .replace("\t", "?")
            .replace("\n", "?")
        )
        pod_uid, container_id = parse_cgroup_identity(
            self._read_text(os.path.join(base, "cgroup"))
        )
        return tuple(
            DeviceHolder(
                pid=pid,
                comm=comm,
                device_path=dp,
                pod_uid=pod_uid,
                container_id=container_id,
            )
            for dp in sorted(device_paths)
        )

    @staticmethod
    def _read_text(path: str) -> str:
        try:
            # newline="" disables universal-newline translation: a literal
            # \r inside a comm must stay \r, byte-for-byte with the native
            # scanner's raw read (verify-path parity).
            with open(path, encoding="utf-8", errors="replace", newline="") as f:
                return f.read()
        except OSError:
            return ""

    @staticmethod
    def _flatten(by_pid: dict[int, tuple[DeviceHolder, ...]]) -> tuple[DeviceHolder, ...]:
        out: list[DeviceHolder] = []
        for pid in sorted(by_pid):
            out.extend(by_pid[pid])
        return tuple(out)
