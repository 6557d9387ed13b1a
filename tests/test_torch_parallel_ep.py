"""The port's edge parallelism against the JAX package's on the CPU: the
(1, 4) mesh, one gloo world of 4 workers running every case below
(tests/test_torch_parallel.py says how; its helpers are used here).
Tolerances, each test's own:

* one SGD step of CGCNN, MPNN, SchNet, MEGNet and GCN against
  make_spmd_train_step at (1, 4), as test_torch_parallel.py's (2, 1) and
  (2, 2) cases: loss to rtol 1e-6, parameters to atol 1e-6·max(1,
  max|JAX layer|), every rank equal to rank 0;
* MEGNet's edge pools (global_max_pool: the max exchanged before its
  empty → 0 clamp; global_sum_pool) under ep: the same limits;
* MEGNet with BatchNorm (8 graphs, two blocks) with the edge BatchNorms'
  statistics summed over the ep group against JAX's step with ep_axis:
  loss to 5e-4, parameters and running statistics to atol 2e-3·max(1,
  max|JAX leaf|), the limits tests/test_ring_ep.py holds JAX's own ring
  step to (this model's conditioning: chained BatchNorm rsqrt); without
  the group (each member's statistics over its own edge rows) the loss
  misses JAX's by more than 20 times that limit;
* `ep_impl: gspmd` (the edge operand gathered, reduced whole) against the
  ring path in the same world, CGCNN and MEGNet with the max pool: loss to
  rtol 1e-6, parameters to atol 1e-6·max(1, max|ring layer|) (the same
  sums in another order).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from matdeeplearn_tpu.models import build_model as j_build_model

from test_torch_parallel import (HP, MODELS, assert_ranks_agree, assert_state,
                                 case_results, jax_state, jax_step,
                                 port_dataset_dir, start_world, step_case,
                                 wait_world)

DP, EP = 1, 4
POOLS = ("global_max_pool", "global_sum_pool")
BN_HP = {"gc_count": 2, "batch_norm": True, "batch_track_stats": True}
BN_BATCH = 8
BN_LOSS, BN_PARAMS = 5e-4, 2e-3


@pytest.fixture(scope="module")
def runs(toy_dataset, tmp_path_factory):
    ds = toy_dataset
    root = str(tmp_path_factory.mktemp("parallel_ep"))
    dataset_dir = port_dataset_dir(ds, root)
    states = {name: jax_state(ds, name) for name in MODELS}
    states.update({pool: jax_state(ds, "MEGNet", {"pool": pool})
                   for pool in POOLS})
    states["bn"] = jax_state(ds, "MEGNet", BN_HP, batch=BN_BATCH)
    cases = [step_case(name, "MEGNet" if name in POOLS else name,
                       s[5], DP, {"pool": name} if name in POOLS else None)
             for name, s in states.items() if name != "bn"]
    cases += [step_case("bn", "MEGNet", states["bn"][5], DP, BN_HP,
                        batch=BN_BATCH),
              step_case("bn_no_group", "MEGNet", states["bn"][5], DP, BN_HP,
                        batch=BN_BATCH, no_group=True),
              step_case("gspmd_CGCNN", "CGCNN", states["CGCNN"][5], DP,
                        ep_impl="gspmd"),
              step_case("gspmd_max", "MEGNet", states[POOLS[0]][5], DP,
                        {"pool": POOLS[0]}, ep_impl="gspmd")]
    world = start_world(root, DP, EP, cases, dataset_dir)
    model_ep = j_build_model("MEGNet", ds, {**HP, **BN_HP, "ep_axis": "ep"})
    with ThreadPoolExecutor(4) as pool:  # as test_torch_parallel.py's
        steps = {name: pool.submit(jax_step, s, DP, EP)
                 for name, s in states.items() if name != "bn"}
        steps["bn"] = pool.submit(jax_step, states["bn"], DP, EP,
                                  model=model_ep,
                                  ids=np.arange(BN_BATCH, dtype=np.int32))
        ref = {k: f.result() for k, f in steps.items()}
    return wait_world(world), ref


@pytest.mark.parametrize("name", MODELS + POOLS)
def test_step_matches_jax_spmd_step(runs, name):
    port, ref = runs
    results = case_results(port, name)
    state, loss, count = ref[name]
    assert float(results[0]["count"]) == count == 2
    np.testing.assert_allclose(float(results[0]["loss"]), loss, rtol=1e-6)
    assert_state(results[0], state, name)
    assert_ranks_agree(results, name)


def test_megnet_edge_batchnorm_sums_over_ep(runs):
    port, ref = runs
    state, loss, count = ref["bn"]
    results = case_results(port, "bn")
    assert float(results[0]["count"]) == count == BN_BATCH
    assert abs(float(results[0]["loss"]) - loss) < BN_LOSS
    for k, v in state.items():
        tol = BN_PARAMS * max(1.0, float(v.abs().max()))
        np.testing.assert_allclose(results[0][k], v.numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    assert_ranks_agree(results, "bn")
    alone = case_results(port, "bn_no_group")[0]
    assert abs(float(alone["loss"]) - loss) > 20 * BN_LOSS


@pytest.mark.parametrize("name,ring", [("gspmd_CGCNN", "CGCNN"),
                                       ("gspmd_max", POOLS[0])])
def test_gspmd_equals_the_ring_path(runs, name, ring):
    port, _ = runs
    got, want = case_results(port, name), case_results(port, ring)
    np.testing.assert_allclose(float(got[0]["loss"]), float(want[0]["loss"]),
                               rtol=1e-6)
    assert_state(got[0], {k: torch.as_tensor(v) for k, v in want[0].items()
                          if k not in ("loss", "count")}, name)
    assert_ranks_agree(got, name)
