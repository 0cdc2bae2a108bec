"""The port's meshed Trainer on a (2, 1) gloo world: data parallelism,
DistributedDataParallel over the data group and the synchronized fused-BN
path, against JAX's meshed Trainer with ``fused_bn="full"`` and against the
port's single-process steps on the global batch (see
``torch_parallel_jax.train_world``)."""

import pytest

import torch_parallel_jax as J


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return J.train_world(tmp_path_factory.mktemp("mesh21"), 2, 1, "full")


def test_mesh_layout(world):
    J.assert_mesh_layout(world)


def test_matches_jax_meshed_trainer(world):
    J.assert_matches_jax(world)


@pytest.mark.parametrize("run", [1, 2], ids=["unfused", "full-clipped"])
def test_matches_one_process(world, run):
    J.assert_matches_one_process(world, run)
