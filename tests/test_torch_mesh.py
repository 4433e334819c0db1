"""parallel/mesh.py: the port's ``make_mesh`` against the JAX package's on
its 8 forced CPU devices (the same shapes, the same errors in the same
words), the explicit device lists that put several shards on one device,
and the in-process gather and all-reduce."""

import numpy as np
import pytest
import torch

from codemix_dense_retrieval_torch.parallel import mesh as port
from codemix_dense_retrieval_tpu.parallel import mesh as ref

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("shard,tp", [(-1, 1), (-1, 2), (-1, 4), (2, 4), (8, 1), (1, 1), (3, 2), (1, 8)])
def test_make_mesh_shapes_match_jax(eight_cpu_devices, shard, tp):
    want = ref.make_mesh(shard=shard, tp=tp, devices=eight_cpu_devices)
    got = port.make_mesh(shard=shard, tp=tp, devices=CPU8)
    assert dict(got.shape) == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert port.shard_axis_size(got) == ref.shard_axis_size(want)
    assert got.shard_devices() == [torch.device("cpu")] * want.devices.shape[0]


@pytest.mark.parametrize("shard,tp", [(-1, 3), (3, 3), (9, 1), (2, 5)])
def test_make_mesh_errors_match_jax(eight_cpu_devices, shard, tp):
    with pytest.raises(ValueError) as want:
        ref.make_mesh(shard=shard, tp=tp, devices=eight_cpu_devices)
    with pytest.raises(ValueError) as got:
        port.make_mesh(shard=shard, tp=tp, devices=CPU8)
    assert str(got.value) == str(want.value)


def test_default_devices_are_the_visible_cards_each_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = port.make_mesh()
    assert m.shape == {"shard": 3, "tp": 1}
    assert m.shard_devices() == [torch.device("cuda", i) for i in range(3)]
    with pytest.raises(ValueError, match="mesh 4x1 needs 4 devices, have 3"):
        port.make_mesh(shard=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.make_mesh()


def test_repeated_devices_and_distinct_devices():
    m = port.make_mesh(shard=4, devices=["cpu", "meta", "cpu", "meta"])
    assert m.shard_devices() == [torch.device(d) for d in ("cpu", "meta", "cpu", "meta")]
    assert m.distinct_devices() == [torch.device("cpu"), torch.device("meta")]
    assert m.local_shards == 4 and m.first_shard == 0 and m.process_count == 1
    one = port.as_mesh("cpu")
    assert one.shape == {"shard": 1, "tp": 1} and port.as_mesh(m) is m


def test_multi_process_shape_counts_every_process():
    local = port.make_mesh(shard=2, devices=["cpu", "cpu"])
    m = port.Mesh(local.devices, process_index=1, process_count=3)
    assert m.shape == {"shard": 6, "tp": 1}
    assert m.local_shards == 2 and m.first_shard == 2


def test_gather_and_reduce_sum():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(4)]
    cpu = torch.device("cpu")
    np.testing.assert_array_equal(port.gather_to(parts, cpu).numpy(), np.concatenate(parts, axis=1))
    np.testing.assert_array_equal(port.gather_to(parts, cpu, dim=0).numpy(), np.concatenate(parts, axis=0))
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(port.reduce_sum_to(parts, cpu), want)
