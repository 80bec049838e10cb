"""The port as users deploy it: deploy/gpu/ and the wheel, held against the
reference's deploy files and the port's own parsers.

The cases of tests/test_deploy.py against the port's schema and server
(the three new manifests among those that must parse); the GPU DaemonSet
against the reference's commented GPU variant, which it makes live; the
aggregator and replica manifests against the reference's; every
container's args through the port's own parser; the wheel (built offline
from a copy of what deploy/gpu/Dockerfile copies) and the Dockerfile; and
the image's runtime stage emulated here as chip_smoke.py's deploy phase
runs it on the card's host, on simulated GPUs: the DaemonSet's container
from the read-only unpacked wheel, with torch, jax and triton refused.
"""

import argparse
import configparser
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tomllib
import urllib.request
import zipfile
from pathlib import Path

import pytest
import yaml

import chip_smoke
from tpu_pod_exporter_torch import aggregate, nativelib, shard
from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.metrics import HistogramSpec, schema

REPO = Path(__file__).resolve().parent.parent
DEPLOY = REPO / "deploy"
GPU = DEPLOY / "gpu"
PORT_IMAGE = "tpu-pod-exporter-torch:latest"
METRIC_RE = re.compile(r"\btpu_[a-z0-9_]+\b")
NON_METRIC_TOKENS = {"tpu_pod_exporter"}
# What the port's wheel must carry beyond its Python modules.
PORT_DATA = (
    "native/tpumon.cc",
    "kernels/csrc/online_softmax.cu",
    "kernels/csrc/sgd_update.cu",
    "kernels/csrc/stage_rows.cu",
    "kernels/csrc/tanh_matmul.cu",
    "kernels/csrc/tanh_matmul_sm90.cu",
    "analysis/baseline.json",
    "analysis/reviewed/fork-inventory.json",
    "analysis/reviewed/lock-graph.dot",
    "analysis/reviewed/lock-graph.json",
    "attribution/proto/podresources.proto",
    "backend/proto/tpu_metric_service.proto",
)
PORT_SCRIPTS = {
    "tpu-pod-exporter-torch": "tpu_pod_exporter_torch.app:main",
    "tpu-pod-exporter-torch-status": "tpu_pod_exporter_torch.status:main",
    "tpu-pod-exporter-torch-aggregate": "tpu_pod_exporter_torch.aggregate:main",
    "tpu-pod-exporter-torch-shard": "tpu_pod_exporter_torch.shard:main",
    "tpu-pod-exporter-torch-loadgen": "tpu_pod_exporter_torch.loadgen.__main__:main",
    "tpu-pod-exporter-torch-probe": "tpu_pod_exporter_torch.probe:main",
    "tpu-pod-exporter-torch-hwcheck": "tpu_pod_exporter_torch.hwcheck:main",
    "tpu-pod-exporter-torch-tunnelwatch": "tpu_pod_exporter_torch.tunnelwatch:main",
    "tpu-pod-exporter-torch-history": "tpu_pod_exporter_torch.history:main",
    "tpu-pod-exporter-torch-persist": "tpu_pod_exporter_torch.persist:main",
    "exporter-lint-torch": "tpu_pod_exporter_torch.analysis.__main__:main",
}
DEPLOYMENTS = ("daemonset.yaml", "aggregator.yaml", "replica.yaml")


def objects(path: Path) -> list:
    return [d for d in yaml.safe_load_all(path.read_text()) if d]


def containers(path: Path) -> list:
    """(object name, container) of every workload in a manifest."""
    return [(obj["metadata"]["name"], c) for obj in objects(path)
            if obj["kind"] in ("DaemonSet", "Deployment")
            for c in obj["spec"]["template"]["spec"]["containers"]]


def reference_gpu_variant() -> dict:
    """The GPU DaemonSet that deploy/daemonset.yaml carries commented out."""
    commented = (DEPLOY / "daemonset.yaml").read_text().split("\n---\n", 1)[1]
    lines = [ln[2:] if ln.startswith("# ") else ln[1:]
             for ln in commented.splitlines() if ln.startswith("#")]
    return yaml.safe_load("\n".join(lines[lines.index("apiVersion: apps/v1"):]))


def schema_metric_names() -> set:
    names = set()
    for val in vars(schema).values():
        name = getattr(val, "name", None)
        if isinstance(name, str) and name.startswith("tpu_"):
            names.add(name)
        if isinstance(val, HistogramSpec):
            base = val.parent.name
            names |= {f"{base}_bucket", f"{base}_count", f"{base}_sum"}
    return names


def recorded_rule_names(doc) -> set:
    return {rule["record"] for group in (doc or {}).get("groups", [])
            for rule in group.get("rules", []) if rule.get("record")}


def pyproject() -> dict:
    return tomllib.loads((REPO / "pyproject.toml").read_text())


# ------------------------------------------- the cases of test_deploy.py


@pytest.mark.parametrize("manifest", [
    "daemonset.yaml", "aggregator.yaml", "replica.yaml", "prometheus-example.yaml",
    "prometheus-rules.yaml", *(f"gpu/{name}" for name in DEPLOYMENTS)])
def test_manifest_parses(manifest):
    assert list(yaml.safe_load_all((DEPLOY / manifest).read_text()))


def test_rules_reference_only_port_schema_metrics():
    doc = yaml.safe_load((DEPLOY / "prometheus-rules.yaml").read_text())
    known = schema_metric_names() | recorded_rule_names(doc) | NON_METRIC_TOKENS
    referenced = set(METRIC_RE.findall((DEPLOY / "prometheus-rules.yaml").read_text()))
    assert referenced - known == set()


def test_grafana_dashboard_references_only_port_schema_metrics():
    text = (DEPLOY / "grafana-dashboard.json").read_text()
    json.loads(text)
    doc = yaml.safe_load((DEPLOY / "prometheus-rules.yaml").read_text())
    known = schema_metric_names() | recorded_rule_names(doc) | NON_METRIC_TOKENS
    assert set(METRIC_RE.findall(text)) - known == set()


@pytest.mark.parametrize("manifest", ["daemonset.yaml", "gpu/daemonset.yaml"])
def test_daemonset_probes_match_port_server_endpoints(manifest):
    ds = next(d for d in objects(DEPLOY / manifest) if d["kind"] == "DaemonSet")
    container = ds["spec"]["template"]["spec"]["containers"][0]
    paths = [container["readinessProbe"]["httpGet"]["path"],
             container["livenessProbe"]["httpGet"]["path"]]
    assert paths == ["/readyz", "/healthz"]
    app = ExporterApp(ExporterConfig(port=0, host="127.0.0.1", backend="fake", fake_chips=2,
                                     attribution="none"))
    app.collector.poll_once()
    app.server.start()
    try:
        for path in paths:
            with urllib.request.urlopen(f"http://127.0.0.1:{app.port}{path}", timeout=5) as r:
                assert r.status == 200, path
    finally:
        app.stop()


def test_every_alert_has_a_runbook_entry():
    rules = (DEPLOY / "prometheus-rules.yaml").read_text()
    runbook = (DEPLOY / "RUNBOOK.md").read_text()
    alerts = re.findall(r"- alert: (\w+)", rules)
    assert alerts
    assert [a for a in alerts if f"## {a}" not in runbook] == []
    documented = re.findall(r"^## (\w+)", runbook, flags=re.M)
    assert [d for d in documented if d not in alerts] == []


# ------------------------------------------------------- the manifests


def test_gpu_daemonset_is_the_reference_variant_made_live():
    ref = reference_gpu_variant()
    ds = next(d for d in objects(GPU / "daemonset.yaml") if d["kind"] == "DaemonSet")
    assert ds["metadata"] == ref["metadata"]
    assert ds["spec"]["selector"] == ref["spec"]["selector"]
    assert ds["spec"]["updateStrategy"] == ref["spec"]["updateStrategy"]
    pod, ref_pod = ds["spec"]["template"]["spec"], ref["spec"]["template"]["spec"]
    assert ds["spec"]["template"]["metadata"] == ref["spec"]["template"]["metadata"]
    assert {k: v for k, v in pod.items() if k not in ("containers", "volumes")} == \
        {k: v for k, v in ref_pod.items() if k not in ("containers", "volumes")}
    (c,), (rc,) = pod["containers"], ref_pod["containers"]
    for key in ("name", "args", "ports", "readinessProbe", "livenessProbe", "resources"):
        assert c[key] == rc[key], key
    assert c["image"] == PORT_IMAGE and rc["image"] != PORT_IMAGE
    assert "command" not in c and "command" not in rc
    # The departures: the host driver, /dev, and the device cgroup lifted.
    assert c["securityContext"] == {**rc["securityContext"], "privileged": True}
    assert c["env"][:len(rc["env"])] == rc["env"]
    (ld,) = c["env"][len(rc["env"]):]
    mounts = {m["name"]: m for m in c["volumeMounts"]}
    assert [m for m in c["volumeMounts"] if m["name"] not in ("dev", "nvidia-driver")] == \
        rc["volumeMounts"]
    assert mounts["dev"] == {"name": "dev", "mountPath": "/dev", "readOnly": True}
    driver = mounts["nvidia-driver"]
    assert driver["readOnly"] is True
    assert ld["name"] == "LD_LIBRARY_PATH" and ld["value"] == driver["mountPath"] + "/lib64"
    volumes = {v["name"]: v for v in pod["volumes"]}
    assert [v for v in pod["volumes"] if v["name"] not in ("dev", "nvidia-driver")] == \
        ref_pod["volumes"]
    assert volumes["dev"]["hostPath"]["path"] == "/dev"
    assert volumes["nvidia-driver"]["hostPath"]["path"] == "/home/kubernetes/bin/nvidia"
    assert "nvidia.com/gpu" not in json.dumps(c["resources"])


@pytest.mark.parametrize("manifest", ["aggregator.yaml", "replica.yaml"])
def test_fleet_manifests_are_the_reference_on_the_port(manifest):
    """The reference's objects and flags; only the image and the command's
    module differ."""
    ref_text = (DEPLOY / manifest).read_text()
    ref_text = ref_text.replace("image: tpu-pod-exporter:latest", f"image: {PORT_IMAGE}")
    ref_text = ref_text.replace('"tpu_pod_exporter.', '"tpu_pod_exporter_torch.')
    assert objects(GPU / manifest) == [d for d in yaml.safe_load_all(ref_text) if d]
    for _, c in containers(GPU / manifest):
        assert c["image"] == PORT_IMAGE


def _parse_only(main, argv: list) -> argparse.Namespace:
    """The namespace ``main``'s own parser makes of ``argv``; main stops
    right after parsing."""
    got = {}
    original = argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        got["ns"] = original(self, args, namespace)
        raise Parsed

    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(Parsed):
            main(argv)
    finally:
        argparse.ArgumentParser.parse_args = original
    return got["ns"]


@pytest.mark.parametrize("manifest,name", [
    (manifest, name) for manifest in DEPLOYMENTS for name, _ in containers(GPU / manifest)])
def test_container_args_parse_with_the_ports_parsers(manifest, name):
    (c,) = [c for n, c in containers(GPU / manifest) if n == name]
    args = c["args"]
    if "command" not in c:
        cfg = ExporterConfig.from_args(args)
        assert (cfg.backend, cfg.port, cfg.memory_budget_mb) == ("nvml", 8000, 256)
        return
    module = c["command"][2]
    main = {"tpu_pod_exporter_torch.aggregate": aggregate.main,
            "tpu_pod_exporter_torch.shard": shard.main}[module]
    ns = _parse_only(main, args)
    for arg in args:
        flag, _, value = arg.partition("=")
        got = getattr(ns, flag[2:].replace("-", "_"))
        assert str(got) == value or got == float(value), (flag, got)


@pytest.mark.parametrize("manifest", DEPLOYMENTS)
def test_commands_and_entrypoint_name_the_port(manifest):
    scripts = pyproject()["project"]["scripts"]
    for _, c in containers(GPU / manifest):
        if "command" in c:
            python, dash_m, module = c["command"]
            assert (python, dash_m) == ("python", "-m")
            assert module.startswith("tpu_pod_exporter_torch.")
            assert importlib.util.find_spec(module) is not None
        else:
            entry = chip_smoke.dockerfile_stages()[-1][-1]
            assert entry[0] == "ENTRYPOINT"
            (script,) = json.loads(entry[1])
            assert scripts[script] == "tpu_pod_exporter_torch.app:main"


# ---------------------------------------------------- image and wheel


def test_pyproject_names_the_ports_scripts_and_extra():
    project = pyproject()["project"]
    assert {k: v for k, v in project["scripts"].items()
            if v.startswith("tpu_pod_exporter_torch.")} == PORT_SCRIPTS
    assert project["optional-dependencies"]["loadgen-torch"] == ["torch>=2.4"]
    assert not any("torch" in dep for dep in project["dependencies"])


def test_dockerfile_copy_sources_exist():
    for stage in chip_smoke.dockerfile_stages():
        for instruction, text in stage:
            if instruction == "COPY" and not text.startswith("--from="):
                for source in text.split()[:-1]:
                    assert (REPO / source).exists(), source


def test_dockerfile_runtime_stage_installs_no_torch():
    build, runtime = chip_smoke.dockerfile_stages()
    assert runtime[0] == ("FROM", "python:3.12-slim")
    runs = [text for instruction, text in runtime if instruction == "RUN"]
    assert runs == ["pip install --no-cache-dir /tmp/*.whl && rm /tmp/*.whl"]
    installs = " ".join(t for i, t in runtime if i in ("RUN", "COPY")).lower()
    for word in ("torch", "jax", "cuda", "nvcc", "triton", "["):
        assert word not in installs
    # The build stage compiles the port's libtpumon with nativelib's flags.
    (gpp,) = [t for i, t in build if i == "RUN" and t.startswith("g++ ")]
    assert gpp.split()[1:1 + len(nativelib.CXX_FLAGS)] == list(nativelib.CXX_FLAGS)
    assert "tpu_pod_exporter_torch/native/tpumon.cc" in \
        [t.split()[0] for i, t in build if i == "COPY"]


def test_dockerfile_library_is_the_loaders_first_candidate(monkeypatch):
    _, runtime = chip_smoke.dockerfile_stages()
    env = dict(t.split("=", 1) for i, t in runtime if i == "ENV")
    copied = [t.split()[-1] for i, t in runtime
              if i == "COPY" and t.split()[1].endswith("libtpumon.so")]
    assert copied == [env["TPE_NATIVE_LIB"]]
    monkeypatch.setenv("TPE_NATIVE_LIB", env["TPE_NATIVE_LIB"])
    assert next(nativelib._candidates([])) == Path(env["TPE_NATIVE_LIB"])


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """The image's stages emulated here (chip_smoke.build_image), from a
    build context holding a built library under the port's _build/."""
    tmp = tmp_path_factory.mktemp("image")
    src = chip_smoke.build_context(tmp)
    planted = src / "tpu_pod_exporter_torch" / "_build" / "libplanted.so"
    planted.parent.mkdir(exist_ok=True)
    planted.write_bytes(b"\x7fELF")
    image = chip_smoke.build_image(src, tmp)
    image["tmp"] = tmp
    return image


def test_wheel_carries_the_port(image):
    with zipfile.ZipFile(image["wheel"]) as whl:
        names = whl.namelist()
        (entry_points,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        scripts = configparser.ConfigParser()
        scripts.read_string(whl.read(entry_points).decode())
    for rel in PORT_DATA:
        assert f"tpu_pod_exporter_torch/{rel}" in names, rel
    assert [n for n in names if n.endswith(".so") or "/_build/" in n] == []
    assert {k: v for k, v in scripts["console_scripts"].items()
            if v.startswith("tpu_pod_exporter_torch.")} == PORT_SCRIPTS
    # The JAX package's files in the wheel are its modules, as before.
    jax_files = sorted(n for n in names if n.startswith("tpu_pod_exporter/"))
    modules = sorted(str(p.relative_to(REPO)) for p in (REPO / "tpu_pod_exporter").rglob("*.py"))
    assert jax_files == modules
    port_modules = {str(p.relative_to(REPO))
                    for p in (REPO / "tpu_pod_exporter_torch").rglob("*.py")
                    if "_build" not in p.parts}
    port_files = {n for n in names if n.startswith("tpu_pod_exporter_torch/")}
    assert port_files == port_modules | {f"tpu_pod_exporter_torch/{r}" for r in PORT_DATA}


def test_explicit_nvml_without_the_driver_fails_from_the_image(image):
    """Where libnvidia-ml.so.1 does not load (this host), the DaemonSet's
    `--backend=nvml` is a startup error, not a quiet 0-card exporter."""
    if shutil.which("nvidia-smi"):
        pytest.skip("this host has an NVIDIA driver")
    _, node = chip_smoke.deploy_container("daemonset.yaml", "DaemonSet", "gpu-pod-exporter")
    tmp = image["tmp"] / "no-driver"
    tmp.mkdir()
    args, _ = chip_smoke.container_argv(node, tmp, chip_smoke.free_port())
    env, _ = chip_smoke.container_env(node, image["env"])
    proc = subprocess.run(
        [sys.executable, "-s", "-B", "-c", chip_smoke.DEPLOY_BOOTSTRAP, str(image["site"]),
         "script", image["entrypoint"], *args], cwd=tmp, env=env, capture_output=True,
        text=True, timeout=60)
    assert proc.returncode != 0
    assert "BackendError" in proc.stderr and "libnvidia-ml" in proc.stderr


def test_daemonset_runs_from_the_image_without_torch(image):
    """The deploy phase's emulation on 8 simulated GPUs: the DaemonSet's
    args from the read-only wheel, the aggregator's command on it."""
    tmp = image["tmp"] / "run"
    tmp.mkdir()
    before = chip_smoke.tree_state(image["site"])
    seen = chip_smoke.run_deployment(image, tmp, extra_args=("--nvml-sim-gpus=8",))
    cost = chip_smoke.check_deployment(seen)
    assert len(seen["cards"]) == 8
    assert seen["pool_idle"][1] == 8
    for name, started in seen["started"].items():
        assert Path(started["package"]).is_relative_to(image["site"]), name
        assert started["native_lib"] == image["env"]["TPE_NATIVE_LIB"]
    assert {e["rc"] for e in seen["exits"].values()} == {0}
    for end in seen["exits"].values():
        assert (end["refused_attempts"], end["refused_loaded"]) == ([], [])
    assert cost["peak_rss_bytes"] < 256 << 20
    assert chip_smoke.tree_state(image["site"]) == before
    rewritten = {r.get("arg") or r.get("env") for r in seen["rewrites"]}
    assert rewritten == {"--port", "--state-dir", "NODE_NAME", "LD_LIBRARY_PATH"}
