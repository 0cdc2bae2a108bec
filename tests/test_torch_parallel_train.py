"""The port's meshed Trainer on a (2, 2) gloo world: data parallelism with
synchronized BN and the tensor-parallel head together.

Four CPU ranks are spawned (``torch_parallel_worker``); the references run
in the test process: JAX's meshed ``Trainer`` on a (2, 2) mesh of conftest's
virtual devices, and the port's single-process Trainer on the global batch
(SGD after a global-norm clip that binds, 3 steps on JAX's own dropout
masks; losses, pre-clip gradient norms, and each parameter's change over
the steps; see ``torch_parallel_jax.train_world``). Also JAX's 13-image
ragged validation case, at batch 8 and at batch 12 (where one data rank's
rows are all padding).
"""

import pytest

import torch_parallel_jax as J


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return J.train_world(tmp_path_factory.mktemp("mesh22"), 2, 2, False, val=True)


def test_mesh_layout(world):
    J.assert_mesh_layout(world)


def test_matches_jax_meshed_trainer(world):
    J.assert_matches_jax(world)


@pytest.mark.parametrize("run", [1, 2], ids=["unfused", "full-clipped"])
def test_matches_one_process(world, run):
    J.assert_matches_one_process(world, run)


def test_clip_binds_on_the_global_norm(world):
    norms = world["outs"][0]["runs"][2]["norms"]
    assert min(norms) > 1.0  # the clip limit of run 2 scales every step


def test_ragged_validation(world):
    J.assert_validation(world)
