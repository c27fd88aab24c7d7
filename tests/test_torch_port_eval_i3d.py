"""The port's I3D (evaluation/i3d.py) against the JAX package's flax I3D on
the CPU, fp32, at the FVD protocol's [1, 16, 224, 224, 3] (the only size
the final (2, 7, 7) average pool admits), in both weight directions; and
the TF-Hub bundle's variables mapped onto the port's state_dict.

Limit: the JAX suite's I3D limit, rtol 2e-3 and atol 2e-3 * max|logits|
(tests/test_i3d_parity.py)."""

import jax
import numpy as np
import pytest
import torch

from mm_diffusion_tpu.evaluation import i3d as jax_i3d
from mm_diffusion_tpu.evaluation import tf_bundle as jax_bundle
from mm_diffusion_tpu_torch.evaluation import i3d, tf_bundle
from mm_diffusion_tpu_torch.evaluation.common import load_weights
from mm_diffusion_tpu_torch.weights import i3d_state_dict_from_jax
from test_tf_bundle import _fake_i3d_variables
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_eval_common import assert_close_scaled, randomize_eval_, random_flax_variables, state_dict_np

RTOL = 2e-3


@pytest.fixture(scope="module")
def video():
    return np.random.RandomState(1).uniform(-1, 1, (1, 16, 224, 224, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(jax_i3d.InceptionI3d().apply)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_i3d_logits_match_jax(direction, video, jax_apply):
    if direction == "port_to_jax":
        model = randomize_eval_(i3d.InceptionI3d(), seed=0)
        variables = jax_i3d.convert_torch_i3d(state_dict_np(model))
    else:
        variables = random_flax_variables(jax_i3d.InceptionI3d(), 2, video)
        model = load_weights(i3d.InceptionI3d(), i3d_state_dict_from_jax(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(video)).numpy()
    ref = np.asarray(jax_apply(variables, video))
    assert got.shape == (1, 400)
    assert_close_scaled(got, ref, RTOL)


def test_i3d_state_dict_is_the_converters(tmp_path):
    """The port's module holds exactly the keys the JAX converter reads
    (plus BatchNorm's counters); a .pt of it loads through load_i3d."""
    model = randomize_eval_(i3d.InceptionI3d(), seed=3)
    sd = state_dict_np(model)
    back = i3d_state_dict_from_jax(jax_i3d.convert_torch_i3d(sd))
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    torch.save(model.state_dict(), tmp_path / "i3d.pt")
    loaded = i3d.load_i3d(str(tmp_path / "i3d.pt"))
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)


def test_tf_bundle_i3d_maps_onto_the_port(tmp_path):
    """convert_tf_i3d gives the state_dict of what the JAX converter gives
    (equal arrays), and load_i3d reads a TF-Hub module directory."""
    variables = _fake_i3d_variables(np.random.default_rng(5))
    got = tf_bundle.convert_tf_i3d(variables)
    ref = i3d_state_dict_from_jax(jax_bundle.convert_tf_i3d(variables))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    module = tmp_path / "i3d-kinetics-400"
    jax_bundle.write_bundle(str(module / "variables" / "variables"), variables)
    model = i3d.load_i3d(str(module))
    np.testing.assert_array_equal(model.Mixed_5b.b2b.conv3d.weight.numpy(),
                                  np.transpose(variables["RGB/inception_i3d/Mixed_5b/Branch_2/Conv3d_0a_3x3/conv_3d/w"],
                                               (4, 3, 0, 1, 2)))
