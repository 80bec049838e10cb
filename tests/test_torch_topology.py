"""The cases of tests/test_topology.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Topology parsing + env detection tests."""

from tpu_pod_exporter_torch.topology import (
    HostTopology,
    detect_host_topology,
    parse_accelerator_type,
)


class TestParseAcceleratorType:
    def test_v4_8(self):
        t = parse_accelerator_type("v4-8")
        assert (t.generation, t.total_cores, t.total_chips) == ("v4", 8, 4)
        assert t.chips_per_host == 4
        assert t.num_hosts == 1
        assert not t.multi_host

    def test_v5p_64(self):
        t = parse_accelerator_type("v5p-64")
        assert t.total_chips == 32
        assert t.num_hosts == 8
        assert t.multi_host

    def test_v5litepod_16(self):
        t = parse_accelerator_type("v5litepod-16")
        assert t.total_chips == 16
        assert t.chips_per_host == 8
        assert t.num_hosts == 2

    def test_v5e_alias(self):
        t = parse_accelerator_type("v5e-16")
        assert t.total_chips == 16

    def test_sub_host_slice(self):
        t = parse_accelerator_type("v5litepod-4")
        assert t.total_chips == 4
        assert t.chips_per_host == 4
        assert t.num_hosts == 1

    def test_unknown_generation_degrades(self):
        t = parse_accelerator_type("v99-8")
        assert t.accelerator == "v99-8"
        assert t.total_chips == 0

    def test_garbage_degrades(self):
        assert parse_accelerator_type("").total_chips == 0
        assert parse_accelerator_type("no-dash-num").total_chips == 0


class TestDetectHostTopology:
    def test_env_detection(self):
        env = {
            "TPU_ACCELERATOR_TYPE": "v5p-64",
            "TPU_WORKER_ID": "3",
            "NODE_NAME": "gke-node-7",
            "TPU_SLICE_NAME": "slice-a",
        }
        t = detect_host_topology(env=env)
        assert t.accelerator == "v5p-64"
        assert t.worker_id == "3"
        assert t.host == "gke-node-7"
        assert t.slice_name == "slice-a"
        assert t.slice_topology.multi_host

    def test_overrides_beat_env(self):
        env = {"TPU_ACCELERATOR_TYPE": "v4-8"}
        t = detect_host_topology(env=env, accelerator="v5e-16", worker_id="1")
        assert t.accelerator == "v5e-16"
        assert t.worker_id == "1"

    def test_hostname_fallback(self):
        t = detect_host_topology(env={})
        assert t.host  # socket.gethostname()

    def test_labels(self):
        t = HostTopology(accelerator="v4-8", slice_name="s", host="h", worker_id="0")
        assert t.labels() == {
            "accelerator": "v4-8",
            "slice_name": "s",
            "host": "h",
            "worker_id": "0",
        }


class TestMultislice:
    def test_megascale_env_detection(self):
        env = {
            "TPU_ACCELERATOR_TYPE": "v5p-128",
            "MEGASCALE_COORDINATOR_ADDRESS": "train-job-0.headless:8080",
            "MEGASCALE_NUM_SLICES": "2",
            "MEGASCALE_SLICE_ID": "1",
        }
        t = detect_host_topology(env=env)
        assert t.multislice_group == "train-job-0.headless"  # port stripped
        assert t.num_slices == "2"
        assert t.slice_name == "1"  # MEGASCALE_SLICE_ID fallback
        assert t.host_info_labels()["multislice_group"] == "train-job-0.headless"

    def test_override_beats_env(self):
        env = {"MEGASCALE_COORDINATOR_ADDRESS": "coord:8080"}
        t = detect_host_topology(env=env, multislice_group="my-group")
        assert t.multislice_group == "my-group"

    def test_override_taken_verbatim_even_with_colons(self):
        # An operator's group name may contain colons; only the ENV-derived
        # endpoint gets port-stripped.
        t = detect_host_topology(env={}, multislice_group="team:prod")
        assert t.multislice_group == "team:prod"

    def test_bare_ipv6_coordinator_not_mangled(self):
        env = {"MEGASCALE_COORDINATOR_ADDRESS": "fd00::a"}
        t = detect_host_topology(env=env)
        assert t.multislice_group == "fd00::a"  # tail not numeric: kept

    def test_bracketed_ipv6_with_port_stripped(self):
        env = {"MEGASCALE_COORDINATOR_ADDRESS": "[fd00::a]:8080"}
        t = detect_host_topology(env=env)
        assert t.multislice_group == "[fd00::a]"

    def test_not_multislice_is_empty(self):
        t = detect_host_topology(env={})
        assert t.multislice_group == ""
        assert t.num_slices == ""
        assert t.host_info_labels()["multislice_group"] == ""
