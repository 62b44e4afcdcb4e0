"""The combustion step of the PyTorch port against the JAX ``make_step``
in every branch at τ_flow = 0.8, w_e = 1.1, w_eps = 1.2, w_q = 1.3, where
every flow moment relaxes at its own rate (at the defaults the flow
relaxation diagonal is all ones).  The cases and the tolerance are those of
tests/test_torch_combustion_step.py, which runs the default rates; the two
files are apart so that the tier-1 run's workers take them in parallel.
"""
import pytest
import torch

from test_torch_combustion_step import BRANCHES, FULL_MRT, run_branch

# The tier-1 command runs six xdist workers; with one intra-op thread
# per core in each, PyTorch's pools spin against each other (a plain HCZ
# step measured 2,180 ms against 19 ms with one thread per worker).
torch.set_num_threads(1)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_step_matches_jax_at_full_mrt_rates(branch):
    run_branch(branch, FULL_MRT)
