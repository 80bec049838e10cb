"""The cases of tests/test_backend_discovery.py against
``tpu_pod_exporter_torch``, with the imports renamed and the one designed
difference expected as such.

Device discovery tests against fake /dev trees.

The designed difference: the port's ``local_chip_count``, ``discover_chips``
and ``list_device_paths`` scan ``/dev/nvidia<digits>``, and the TPU host's
scan (accel nodes; vfio groups only where there are none; then the sysfs
accel class) is kept as ``list_tpu_device_paths``, which the libtpu backend
keys its chips by. So on each TPU tree below the port's GPU scan finds no
card, the JAX package's scan finds the reference's chips, and
``list_tpu_device_paths`` gives the JAX package's paths; the case's own
assertions hold of those. The port's native ``tpumon_count_devices`` (the
reference's source byte for byte) still counts the TPU nodes.
"""

from tpu_pod_exporter.backend import discovery as jax_discovery
from tpu_pod_exporter_torch.backend.discovery import (
    discover_chips,
    list_device_paths,
    list_tpu_device_paths,
    local_chip_count,
)


def make_dev_tree(tmp_path, names):
    (tmp_path / "dev").mkdir(exist_ok=True)
    for n in names:
        (tmp_path / "dev" / n).touch()
    return str(tmp_path)


def assert_tpu_tree(root, count):
    """The designed difference on a TPU tree: the port's GPU scan finds no
    card; the JAX package's scan finds ``count`` chips, at the paths the
    port's TPU scan gives."""
    assert local_chip_count(root) == 0
    assert discover_chips(root) == []
    assert list_device_paths(root) == []
    assert jax_discovery.local_chip_count(root) == count
    assert list_tpu_device_paths(root) == jax_discovery.list_device_paths(root)
    assert len(list_tpu_device_paths(root)) == count


class TestDiscovery:
    def test_accel_nodes(self, tmp_path):
        root = make_dev_tree(tmp_path, ["accel0", "accel1", "accel2", "accel3"])
        assert_tpu_tree(root, 4)
        chips = jax_discovery.discover_chips(root)
        assert [c.chip_id for c in chips] == [0, 1, 2, 3]
        assert chips[0].device_path.endswith("/dev/accel0")
        assert list_tpu_device_paths(root)[0].endswith("/dev/accel0")
        assert chips[2].device_ids == ("2",)

    def test_numeric_sort_not_lexicographic(self, tmp_path):
        root = make_dev_tree(tmp_path, [f"accel{i}" for i in range(12)])
        assert_tpu_tree(root, 12)
        chips = jax_discovery.discover_chips(root)
        assert [c.chip_id for c in chips] == list(range(12))
        assert list_tpu_device_paths(root) == [f"/dev/accel{i}" for i in range(12)]

    def test_vfio_nodes(self, tmp_path):
        (tmp_path / "dev" / "vfio").mkdir(parents=True)
        for i in range(4):
            (tmp_path / "dev" / "vfio" / str(i)).touch()
        assert_tpu_tree(str(tmp_path), 4)
        paths = list_tpu_device_paths(str(tmp_path))
        assert len(paths) == 4

    def test_empty_host(self, tmp_path):
        assert local_chip_count(str(tmp_path)) == 0
        assert discover_chips(str(tmp_path)) == []

    def test_non_numeric_accel_suffix_ignored(self, tmp_path):
        root = make_dev_tree(tmp_path, ["accel0", "accelfoo", "accel_dbg"])
        assert_tpu_tree(root, 1)
        assert [c.chip_id for c in jax_discovery.discover_chips(root)] == [0]
        assert list_tpu_device_paths(root) == ["/dev/accel0"]

    def test_vfio_ignored_when_accel_present(self, tmp_path):
        root = make_dev_tree(tmp_path, ["accel0", "accel1"])
        (tmp_path / "dev" / "vfio").mkdir()
        (tmp_path / "dev" / "vfio" / "7").touch()  # unrelated passthrough group
        assert_tpu_tree(root, 2)
        assert len(list_tpu_device_paths(root)) == 2

    def test_sysfs_fallback_when_no_dev_nodes(self, tmp_path):
        accel = tmp_path / "sys" / "class" / "accel"
        accel.mkdir(parents=True)
        for i in range(4):
            (accel / f"accel{i}").mkdir()
        (accel / "accelctl").mkdir()  # non-numeric ignored
        root = str(tmp_path)
        assert_tpu_tree(root, 4)
        assert [c.chip_id for c in jax_discovery.discover_chips(root)] == [0, 1, 2, 3]
        assert list_tpu_device_paths(root)[0] == "/dev/accel0"

    def test_dev_nodes_beat_sysfs(self, tmp_path):
        make_dev_tree(tmp_path, ["accel0"])
        accel = tmp_path / "sys" / "class" / "accel"
        accel.mkdir(parents=True)
        for i in range(4):
            (accel / f"accel{i}").mkdir()
        assert_tpu_tree(str(tmp_path), 1)

    def test_python_and_native_scans_agree(self, tmp_path):
        from tpu_pod_exporter_torch import nativelib

        lib = nativelib.load()
        if lib is None:
            import pytest

            pytest.skip("native lib not built")
        for names in (["accel0", "accel1", "accelx"], [], ["accel3"]):
            import shutil

            shutil.rmtree(tmp_path / "dev", ignore_errors=True)
            root = make_dev_tree(tmp_path, names)
            assert local_chip_count(root) == 0
            assert lib.tpumon_count_devices(root.encode()) == len(list_tpu_device_paths(root))
