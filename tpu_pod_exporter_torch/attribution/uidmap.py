"""UID → (pod name, namespace) resolution for the checkpoint fallback.

The kubelet device-plugin checkpoint knows only pod *UIDs*
(``checkpoint.py``), so without help the fallback path emits
``pod="uid:<uid>"`` series. Two node-local sources fix that — both avoid
any apiserver call, preserving the design rule that the exporter talks
only to kubelet-local surfaces (SURVEY.md §7 delta 1; the reference
instead pulled the *cluster-wide* pod list, ``main.go:74-89``):

- :class:`StaticUidMap` — a JSON file the operator mounts/renders
  (``{"<uid>": {"name": "...", "namespace": "..."}}``; also accepts
  ``[name, namespace]`` pairs).
- :class:`KubeletPodsUidMap` — the kubelet's own ``/pods`` endpoint
  (``https://127.0.0.1:10250/pods`` with the pod's service-account token,
  or the legacy read-only ``http://127.0.0.1:10255/pods``), refreshed at
  most every ``refresh_s`` seconds and serving the last good map on
  fetch errors (same bounded-staleness posture as the collector).
"""

from __future__ import annotations

import json
import logging
import ssl
import time
import urllib.request
from typing import Mapping

log = logging.getLogger("tpu_pod_exporter_torch.attribution.uidmap")

DEFAULT_TOKEN_FILE = "/var/run/secrets/kubernetes.io/serviceaccount/token"
DEFAULT_CA_FILE = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


class UidMapError(RuntimeError):
    """The UID map source was unreadable/unparseable."""


def parse_uid_map_file(raw: str | bytes) -> dict[str, tuple[str, str]]:
    """Parse the static-file shape: uid -> {name, namespace} | [name, ns]."""
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        raise UidMapError(f"uid map is not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise UidMapError("uid map must be a JSON object keyed by pod UID")
    out: dict[str, tuple[str, str]] = {}
    for uid, val in doc.items():
        if isinstance(val, dict):
            out[str(uid)] = (str(val.get("name", "")), str(val.get("namespace", "")))
        elif isinstance(val, (list, tuple)) and len(val) == 2:
            out[str(uid)] = (str(val[0]), str(val[1]))
        else:
            raise UidMapError(f"uid {uid!r}: expected object or [name, namespace]")
    return out


def parse_kubelet_pods(raw: str | bytes) -> dict[str, tuple[str, str]]:
    """Parse the kubelet ``/pods`` PodList: items[].metadata.{uid,name,namespace}."""
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        raise UidMapError(f"kubelet /pods response is not valid JSON: {e}") from e
    out: dict[str, tuple[str, str]] = {}
    for item in doc.get("items") or []:
        meta = item.get("metadata") or {}
        uid = meta.get("uid")
        if uid:
            out[str(uid)] = (str(meta.get("name", "")), str(meta.get("namespace", "")))
    return out


class StaticUidMap:
    """Operator-provided JSON file; re-read only when its mtime changes."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._mtime: float | None = None
        self._map: dict[str, tuple[str, str]] = {}

    def mapping(self) -> Mapping[str, tuple[str, str]]:
        import os

        try:
            mtime = os.stat(self._path).st_mtime
        except OSError as e:
            raise UidMapError(f"cannot stat uid map {self._path}: {e}") from e
        if mtime != self._mtime:
            with open(self._path, "rb") as f:
                self._map = parse_uid_map_file(f.read())
            self._mtime = mtime
        return self._map


class KubeletPodsUidMap:
    """Kubelet ``/pods`` poller with TTL refresh and last-good fallback."""

    def __init__(
        self,
        url: str,
        token_file: str | None = None,
        ca_file: str | None = None,
        refresh_s: float = 30.0,
        timeout_s: float = 5.0,
        insecure_tls: bool = False,
        _fetch=None,  # test seam: (url, headers, timeout_s) -> bytes
        _clock=time.monotonic,
    ) -> None:
        if url.startswith("https:") and token_file and not ca_file:
            # A bearer token is a real cluster credential; sending it over
            # an unverified TLS channel hands it to any MITM. Refuse at
            # construction (fail loud at startup, not quietly at runtime)
            # unless the operator explicitly accepted the risk.
            if not insecure_tls:
                raise UidMapError(
                    "kubelet_token_file is set for an https kubelet URL but "
                    "kubelet_ca_file is not: refusing to send a bearer token "
                    "over unverified TLS. Set --kubelet-ca-file (the SA "
                    "mount's ca.crt) or explicitly opt in with "
                    "--kubelet-insecure-tls."
                )
            log.warning(
                "sending the kubelet bearer token over UNVERIFIED TLS "
                "(--kubelet-insecure-tls): acceptable only when %s "
                "never leaves this node", url,
            )
        self._url = url
        self._token_file = token_file
        self._ca_file = ca_file
        self._refresh_s = refresh_s
        self._timeout_s = timeout_s
        self._fetch = _fetch or self._http_fetch
        self._clock = _clock
        self._map: dict[str, tuple[str, str]] = {}
        self._fetched_at: float | None = None
        # Cumulative; surfaced by CheckpointAttribution.error_counters() as
        # tpu_exporter_poll_errors_total{source="attribution.uid_map"}.
        self.fetch_errors = 0

    def _http_fetch(self, url: str, headers: dict, timeout_s: float) -> bytes:
        ctx = None
        if url.startswith("https:"):
            if self._ca_file:
                ctx = ssl.create_default_context(cafile=self._ca_file)
                # The kubelet's serving cert is for the node name, not the
                # loopback IP this DaemonSet dials — verify the chain, not
                # the hostname (the socket never leaves the node).
                ctx.check_hostname = False
            else:
                ctx = ssl._create_unverified_context()  # noqa: S323 — node-local
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=timeout_s, context=ctx) as resp:
            return resp.read()

    def _headers(self) -> dict:
        if not self._token_file:
            return {}
        try:
            with open(self._token_file) as f:
                return {"Authorization": f"Bearer {f.read().strip()}"}
        except OSError as e:
            raise UidMapError(
                f"cannot read kubelet token {self._token_file}: {e}"
            ) from e

    def mapping(self) -> Mapping[str, tuple[str, str]]:
        now = self._clock()
        if self._fetched_at is not None and now - self._fetched_at < self._refresh_s:
            return self._map
        try:
            raw = self._fetch(self._url, self._headers(), self._timeout_s)
            self._map = parse_kubelet_pods(raw)
            self._fetched_at = now
        except Exception as e:  # noqa: BLE001 — degrade to last-good map
            self.fetch_errors += 1
            self._fetched_at = now  # back off a full refresh interval
            log.warning("kubelet /pods fetch failed (%s); serving last-good "
                        "uid map (%d entries)", e, len(self._map))
        return self._map
