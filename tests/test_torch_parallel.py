"""clonealign_torch.parallel in one process: the mesh and its refusals, the
cell split against the JAX package's formula, the field layouts, and a
gloo process group of one rank, whose fit equals the plain fit (float64:
rtol 1e-10; the rank's collectives run, and the PCA and the sums over cells
take the mesh's forms, whose rounding differs).
The two-rank runs are tests/test_torch_distributed.py."""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import clonealign_torch as ct
from clonealign_torch.parallel import distributed as dist
from clonealign_torch.parallel import sharding
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.parallel.collectives import CELL_AXIS, Cells, Mesh
from clonealign_torch.synth import simulate_multinomial
from clonealign_tpu.parallel import distributed as jdist

torch.set_num_threads(2)


def test_make_mesh_in_one_process_is_a_world_of_one():
    mesh = sharding.make_mesh(devices="cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"cells": 1, "genes": 1} and mesh.world == 1 and mesh.rank == 0
    assert mesh.device == torch.device("cpu") and mesh.group is None
    assert sharding.make_mesh(devices=["cpu"], cell_parallelism=1).device.type == "cpu"


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(gene_parallelism=2), ValueError, "mesh 0x2 != 1 ranks"),
    (dict(cell_parallelism=3), ValueError, "mesh 3x1"),
    (dict(devices=["cpu", "cpu"]), ValueError, "2 devices for 1 ranks"),
])
def test_make_mesh_refusals(kwargs, error, match):
    with pytest.raises(error, match=match):
        sharding.make_mesh(**{"devices": "cpu", **kwargs})


def test_make_mesh_places_ranks_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices='cpu'"):
        sharding.make_mesh()


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [5, 7, 61, 64, 100_003])
def test_process_cell_slice_follows_the_jax_formula(world, n, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    rows = []
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        got = dist.process_cell_slice(n, rank, world)
        assert got == jdist.process_cell_slice(n)
        rows.extend(range(n)[got])
    assert rows == list(range(n))  # the blocks tile the cells in order


def test_specs_split_the_per_cell_fields_along_the_cells():
    specs = sharding.param_specs()
    cell_fields = {f for f, spec in vars(specs).items() if CELL_AXIS in spec}
    assert cell_fields == {"psi", "gamma_logits"}
    assert all(spec[0] is None for spec in vars(sharding.param_specs(batched=True)).values())
    data = sharding.data_shardings(has_x=True)
    assert {f for f in ("Y", "L", "X", "s", "log_binom", "YlogL", "colsum_Y")
            if CELL_AXIS in getattr(data, f)} == {"Y", "X", "s", "log_binom", "YlogL"}
    assert sharding.data_shardings(has_x=False, has_colsum=False).colsum_Y is None


def test_initialize_alone_is_a_single_process(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert dist.initialize() is False
    assert not tdist.is_initialized()
    assert dist.process_cell_slice(100) == slice(0, 100)


def test_a_mesh_must_come_from_make_mesh():
    sim = simulate_multinomial(N=20, G=10, C=2, seed=1, mean_total=200)
    with pytest.raises(TypeError, match="make_mesh"):
        sharding.sharded_fit(sim.Y, sim.L, object())
    with pytest.raises(TypeError, match="make_mesh"):
        sharding.sharded_negbin_fit(sim.Y, sim.L, object())


@pytest.fixture
def group_of_one():
    """A gloo process group of one rank, destroyed after the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert dist.initialize(f"127.0.0.1:{port}", 1, 0, backend="gloo", timeout_seconds=60) is False
    try:
        assert tdist.is_initialized() and tdist.get_world_size() == 1
        yield sharding.make_mesh(devices="cpu")
    finally:
        tdist.destroy_process_group()


def test_a_gloo_world_of_one_equals_the_plain_fit(group_of_one):
    mesh = group_of_one
    assert mesh.group is not None and mesh.world == 1
    sim = simulate_multinomial(N=40, G=30, C=3, seed=2, mean_total=300)
    kw = dict(initial_shrinks=(0, 5), n_repeats=1, max_iter=15, seed=4, dtype="float64",
              verbose=False, print_elbos=False)
    got = ct.run_clonealign(sim.Y, sim.L, mesh=mesh, **kw)
    want = ct.run_clonealign(sim.Y, sim.L, device="cpu", **kw)
    assert got.clone == want.clone
    assert got.convergence_info.n_iters == want.convergence_info.n_iters
    np.testing.assert_allclose(got.multirun_info["elbos"], want.multirun_info["elbos"], rtol=1e-10)
    np.testing.assert_allclose(got.convergence_info.elbo, want.convergence_info.elbo, rtol=1e-10)
    for name, value in want.ml_params.items():
        np.testing.assert_allclose(got.ml_params[name], value, rtol=1e-8, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(got.correlations, want.correlations, rtol=1e-8, equal_nan=True)

    plain = sharding.sharded_fit(sim.Y, sim.L, Mesh(1, 1, 0, torch.device("cpu")), n_restarts=2,
                                 dtype="float64", max_iter=10, seed=1)
    one = dist.distributed_fit(sim.Y, sim.L, mesh, n_restarts=2, dtype="float64", max_iter=10,
                               seed=1)
    np.testing.assert_array_equal(one.n_iters, plain.n_iters)
    np.testing.assert_allclose(one.final_elbo, plain.final_elbo, rtol=1e-10)

    data = tmm.prepare_data(sim.Y, sim.L, device="cpu", dtype=torch.float64)
    shard = sharding.shard_data(data, mesh)
    assert shard.cells == Cells(mesh, 0, 40, 40)
    for name in ("Y", "L", "s", "log_binom", "YlogL", "colsum_Y"):
        assert torch.equal(getattr(shard, name), getattr(data, name)), name
    extra = torch.zeros(40, 3, dtype=torch.float64)
    assert torch.equal(sharding.shard_extra_log_lik(extra, mesh), extra)
