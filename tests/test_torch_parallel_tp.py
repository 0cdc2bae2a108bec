"""The port's tensor-parallel head on a (1, 2) gloo world, and the parts of
``parallel`` that need no world.

The world: fc1 column-parallel and fc2 row-parallel over two CPU ranks,
against JAX's meshed Trainer on a (1, 2) mesh and the port's single-process
steps (``torch_parallel_jax.train_world``; BN stays per-rank here, so
fused_bn False is torch's BN and "full" the fused twins), and a JAX
``.ckpt`` with Adam state resumed onto it, moments cut like their params.
In process:
``make_mesh`` on a world of 1 and its refusal of a mesh that does not fill
the world, and ``DataLoader(shard_by_process=...)``'s index stream against
JAX's multi-host loader with ``jax.process_index``/``process_count``
monkeypatched.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_jax as J
from yolo_tpu.data.loader import DataLoader as JDataLoader
from yolo_tpu_torch.data import DataLoader
from yolo_tpu_torch.parallel import batch_slice, make_mesh
from yolo_tpu_torch.parallel.mesh import coordinates


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return J.train_world(tmp_path_factory.mktemp("mesh12"), 1, 2, False, ckpt=True)


def test_mesh_layout(world):
    J.assert_mesh_layout(world)


def test_matches_jax_meshed_trainer(world):
    J.assert_matches_jax(world)


@pytest.mark.parametrize("run", [1, 2], ids=["unfused", "full-clipped"])
def test_matches_one_process(world, run):
    J.assert_matches_one_process(world, run)


def test_jax_ckpt_resumes_onto_the_mesh(world):
    """A JAX ``.ckpt`` with Adam state resumed on (1, 2): the gathered weights
    and moments equal the unsharded ones bit for bit, the step carried."""
    want = J.port_state_dict()
    mu, nu = world["moments"]
    for out in world["outs"]:
        assert out["resume"]["meta"]["epoch"] == 3 and out["resume"]["meta"]["val_loss"] == 2.0
        assert out["resume"]["step"] == 1
    got = world["outs"][0]["resume"]  # the gathered state, from the first rank
    for k, v in got["state"].items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    assert sorted(got["moments"]) == sorted(mu)
    for k, (m, v) in got["moments"].items():
        assert torch.equal(m, mu[k]) and torch.equal(v, nu[k]), k


def test_make_mesh_world_of_one():
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        assert coordinates(mesh) == (0, 1, 0, 1)
        rows = np.arange(10)
        np.testing.assert_array_equal(batch_slice(mesh, rows), rows)
        with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
            make_mesh(2, 1, "cpu")
    finally:
        dist.destroy_process_group()


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.zeros(1), np.zeros(1)


@pytest.mark.parametrize("n,batch,shards,drop_last", [(103, 4, 2, True), (103, 5, 4, False),
                                                      (16, 8, 2, True)])
def test_shard_by_process_matches_jax(monkeypatch, n, batch, shards, drop_last):
    for d in range(shards):
        monkeypatch.setattr(jax, "process_index", lambda d=d: d)
        monkeypatch.setattr(jax, "process_count", lambda: shards)
        want = JDataLoader(_Indices(n), batch, shuffle=True, seed=3, drop_last=drop_last,
                           shard_by_process=True, num_workers=0)
        got = DataLoader(_Indices(n), batch, shuffle=True, seed=3, drop_last=drop_last,
                         shard_by_process=(d, shards), num_workers=0)
        for epoch in (0, 2):
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            assert len(got) == len(want)
            w, g = want._index_batches(), got._index_batches()
            assert len(w) == len(g)
            for a, b in zip(w, g):
                np.testing.assert_array_equal(a, b)
