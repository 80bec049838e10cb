"""The port's record/replay backends held against the JAX package's.

The committed GPU recording replays to equal samples through both
packages' ``RecordedBackend``, both ``run_gpu_demo``s come out green, and
``--record-to`` writes a recording that both packages replay to the
samples the live backend served.
"""

import json

from test_torch_nvml import SPEC, plain
from tpu_pod_exporter.backend import recorded as jax_recorded
from tpu_pod_exporter.backend.nvml import run_gpu_demo as jax_run_gpu_demo
from tpu_pod_exporter_torch import app as tapp
from tpu_pod_exporter_torch.backend import nvml, recorded
from tpu_pod_exporter_torch.backend.recorded import RecordedBackend, RecordingBackend
from tpu_pod_exporter_torch.config import ExporterConfig

FIXTURE = "tests/fixtures/gpu-recorded.jsonl"


def test_gpu_fixture_replays_equal():
    backends = [jax_recorded.RecordedBackend(FIXTURE, loop=False),
                RecordedBackend(FIXTURE, loop=False)]
    assert len(backends[1]) == len(backends[0]) > 1
    assert backends[1].family == backends[0].family == "gpu"
    for _ in range(len(backends[0]) + 1):  # the last frame holds
        want, got = (b.sample() for b in backends)
        assert plain(got) == plain(want)


def test_both_gpu_demos_green():
    assert jax_run_gpu_demo(FIXTURE, verbose=False) == 0
    assert nvml.run_gpu_demo(FIXTURE, verbose=False) == 0


def test_link_order_is_numeric_first(tmp_path):
    doc = {"chips": [{"chip_id": 0, "hbm_used": 1.0, "hbm_total": 2.0,
                      "ici": {"10": 1.0, "2": 2.0, "x": 3.0, "1": 4.0},
                      "dcn": {"b": 1.0, "11": 2.0, "3": 3.0}}]}
    path = tmp_path / "links.jsonl"
    path.write_text(json.dumps(doc) + "\n")
    want = jax_recorded.RecordedBackend(str(path)).sample()
    got = RecordedBackend(str(path)).sample()
    assert plain(got) == plain(want)
    assert [l.link for l in got.chips[0].ici_links] == ["1", "2", "10", "x"]
    assert recorded.sample_to_dict(got) == jax_recorded.sample_to_dict(want)


def test_record_to_round_trip(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SPEC))
    path = tmp_path / "trace.jsonl"
    app = tapp.ExporterApp(ExporterConfig(
        port=0, host="127.0.0.1", backend="nvml", nvml_sim_spec=str(spec),
        attribution="none", record_to=str(path)))
    try:
        assert isinstance(app.backend, RecordingBackend)
        assert (app.backend.name, app.backend.family) == ("recording(nvml)", "gpu")
        for _ in range(3):
            app.collector.poll_once()
    finally:
        app.stop()
    live = nvml.NvmlBackend(driver=nvml.sim_driver_from_spec(SPEC))
    want = [plain(live.sample()) for _ in range(3)]
    for replay in (RecordedBackend(str(path), loop=False),
                   jax_recorded.RecordedBackend(str(path), loop=False)):
        assert len(replay) == 3
        assert [plain(replay.sample()) for _ in range(3)] == want
    replayed = tapp.build_backend(ExporterConfig(backend="recorded",
                                                 recording_path=str(path)))
    assert isinstance(replayed, RecordedBackend) and replayed.family == "gpu"
