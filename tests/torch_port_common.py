"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*.py).

The port and the JAX package get the same inputs, made with numpy from a
seed, and are compared in float32 on the CPU.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU ops run fastest single-threaded; the suite runs several
    pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def state_dict_numpy(module):
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def randomize_flax_params(params, seed, scale=0.1):
    """Every leaf of a flax param tree replaced with seeded N(0, scale^2)
    values (so that no zero-initialised head hides a mismatch)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    new = [(rng.randn(*np.shape(l)) * scale).astype(np.float32) for l in leaves]
    return jax.tree_util.tree_unflatten(treedef, new)
