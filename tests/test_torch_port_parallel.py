"""The port's parallel layer (mm_diffusion_tpu_torch/parallel) against the
JAX package, on the CPU over gloo, several processes per test.

One train step of the tiny MM-UNet (tests/test_torch_port_training.py's
config, weights and draws) on W ranks, each on its rows of the global
batch of 4, equals the JAX package's step on the whole batch: with DDP on
2 ranks, with FSDP2 on 2 ranks (the placement threshold lowered so that
the tiny model shards; the sharded set is the JAX rule's), and on a 2x2
(data, fsdp) mesh of 4 ranks.  Accumulation under DDP leaves the gradients
unchanged; the loss-aware sampler on 2 ranks holds the global batch's
history on both, as JAX's fed the same (t, loss).  Then the mesh and
bootstrap pieces on their own.

Tolerances are tests/test_torch_port_training.py's: loss and metrics 2e-5
relative, gradients by ``_assert_grads_close`` (2e-3 relative, floor 1e-4
x the largest), parameters and EMA after the update 1e-6 absolute where
the gradient is resolved."""

import datetime
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_port_training import (  # noqa: F401  (tiny: a fixture)
    B,
    LR,
    SHIFT,
    STEPS,
    T_STEPS,
    TINY,
    _assert_grads_close,
    _batch,
    _jj,
    _noise,
    tiny,
)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_parallel_worker import Launch

from mm_diffusion_tpu import configs as jconfigs
from mm_diffusion_tpu.models.mm_unet import MultimodalUNet as JaxUNet
from mm_diffusion_tpu.parallel import mesh as jmesh
from mm_diffusion_tpu.train import resample as jresample
from mm_diffusion_tpu.train import state as jstate
from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.parallel import make_mesh, param_spec, rank_rows, setup_dist
from mm_diffusion_tpu_torch.train import LossSecondMomentResampler, create_train_state, make_optimizer
from mm_diffusion_tpu_torch.train import TrainLoop, make_train_step
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
from mm_diffusion_tpu_torch.weights import state_dict_from_jax

FSDP_MIN = 512  # shards the tiny model's larger convs; 2**18 shards none of it
HISTORY, SAMPLER_STEPS = 2, 3


def payload(sd):
    """What every worker reads: the weights, config, global batch and draws."""
    rng = np.random.RandomState(9)
    return {
        "sd": sd, "cfg": TINY, "batch": _batch(), "noise": _noise(), "t": T_STEPS, "steps": STEPS,
        "shift": SHIFT, "lr": LR, "history": HISTORY, "sampler_steps": SAMPLER_STEPS,
        "warm_sampler": {  # every timestep's history full: importance sampling from the first step
            "loss_history": torch.from_numpy(rng.rand(STEPS, HISTORY).astype(np.float32) + 0.1),
            "loss_counts": torch.full((STEPS,), HISTORY, dtype=torch.int64),
        },
    }


@pytest.fixture(scope="module")
def launched(tiny, tmp_path_factory):
    """The three launches, started side by side: DDP on 2 ranks, FSDP on
    2, and the 2x2 mesh on 4."""
    _, sd, _ = tiny
    runs = {}
    for name, world, n_fsdp in (("ddp", 2, 1), ("fsdp", 2, 2), ("mesh2x2", 4, 2)):
        work = tmp_path_factory.mktemp(name)
        torch.save(payload(sd), work / "init.pt")
        runs[name] = Launch("step", work, world, n_fsdp, FSDP_MIN)
    return runs


@pytest.fixture(scope="module")
def jax_step(tiny):
    """The JAX package's train step on the global batch, with
    tests/test_torch_port_training.py's draws (jax.random.randint and
    jax.random.normal patched to return them); one compile, the gradients
    read back from Adam's first moment after its first step (mu = 0.1 g)."""
    cfg, sd, params = tiny
    model = JaxUNet(jconfigs.create_model_config(**TINY))
    diffusion = jconfigs.create_gaussian_diffusion(steps=STEPS)
    tx = jstate.make_optimizer(lr=LR)
    by_shape = {v.shape: jnp.asarray(v) for v in _noise().values()}

    def randint(key, shape, lo, hi, *a, **k):
        return jnp.asarray(T_STEPS, jnp.int32) if tuple(shape) == (B,) else jnp.int32(SHIFT)

    def normal(key, shape=(), dtype=jnp.float32):
        return by_shape[tuple(shape)].astype(dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "randint", randint)
    mp.setattr(jax.random, "normal", normal)
    try:
        state = jstate.create_train_state(jax.tree.map(jnp.asarray, params), tx, ema_rates=(0.5,),
                                          num_timesteps=STEPS)
        new_state, metrics = jax.jit(jstate.make_train_step(model, diffusion, tx))(
            state, _jj(_batch()), jax.random.PRNGKey(3)
        )
    finally:
        mp.undo()
    adam = next(x for x in jax.tree_util.tree_leaves(new_state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))
    to_sd = lambda tree: state_dict_from_jax(jax.tree.map(np.asarray, tree), cfg)  # noqa: E731
    return {
        "grads": to_sd(jax.tree.map(lambda m: m / 0.1, adam.mu)), "params": to_sd(new_state.params),
        "ema": to_sd(new_state.ema["0.5"]), "metrics": jax.tree.map(float, metrics),
    }


@pytest.fixture(scope="module")
def ranks(launched, jax_step):
    """Each launch's per-rank outputs (the JAX step compiles meanwhile)."""
    return {name: launch.results() for name, launch in launched.items()}


def _assert_updated_close(got, ref_params, grads, sd):
    """Parameters (or EMA) after one AdamW step: 1e-6 where the JAX
    gradient is resolved, elsewhere a step of at most lr
    (tests/test_torch_port_training.py::test_train_step_matches_jax)."""
    floor = 1e-4 * max(float(v.abs().max()) for v in grads.values())
    for name, ref in ref_params.items():
        mask = grads[name].abs() > floor
        torch.testing.assert_close(got[name][mask], ref[mask], rtol=0, atol=1e-6, msg=name)
        assert float((got[name] - sd[name]).abs().max()) <= LR * 1.001, name


@pytest.mark.parametrize("name", ["ddp", "fsdp", "mesh2x2"])
def test_step_on_ranks_matches_jax_global_step(name, ranks, jax_step, tiny):
    _, sd, _ = tiny
    outs = ranks[name]
    assert {o["kind"] for o in outs} == {"ddp" if name == "ddp" else "fsdp"}
    for out in outs:  # every rank holds the global step's metrics and the whole state
        for k in ("loss", "grad_norm", "param_norm", "loss_q0", "loss_q1", "loss_q2", "loss_q3"):
            np.testing.assert_allclose(out["metrics"][k], jax_step["metrics"][k], rtol=2e-5, err_msg=k)
        _assert_grads_close(out["grads"], jax_step["grads"])
        _assert_updated_close(out["params"], jax_step["params"], jax_step["grads"], sd)
        _assert_updated_close(out["ema"], jax_step["ema"], jax_step["grads"], sd)


@pytest.mark.parametrize("name", ["fsdp", "mesh2x2"])
def test_fsdp_shards_what_the_jax_rule_shards(name, ranks, tiny):
    """The parameters FSDP shards are those the JAX package's param_spec
    shards (mapped through the weight bridge), each on a dim the rule
    allows; at the default 2**18 threshold the tiny model shards nothing
    (tests/test_fsdp.py::test_fsdp_default_threshold_replicates_tiny_model)."""
    cfg, sd, params = tiny
    marks = jax.tree.map(
        lambda leaf: np.full(np.shape(leaf), float(jmesh.param_spec(jnp.asarray(leaf), 2, FSDP_MIN) != jmesh.P()),
                             np.float32),
        params,
    )
    by_jax = {n for n, v in state_dict_from_jax(marks, cfg).items() if bool((v == 1).all())}
    assert 0 < len(by_jax) < len(sd)
    for out in ranks[name]:
        assert out["is_sharded"] and not out["default_threshold_sharded"]
        assert set(out["sharded"]) == by_jax
        for n, dim in out["sharded"].items():
            assert dim == param_spec(sd[n].shape, 2, FSDP_MIN), n


def test_accumulation_under_ddp_leaves_gradients_unchanged(ranks):
    for out in ranks["ddp"]:
        _assert_grads_close(out["grads_accum2"], out["grads"])


def test_loss_aware_sampler_on_ranks_holds_the_global_history(ranks, tiny):
    """Both ranks saw the same global (t, loss) pairs and hold the same
    history; it is JAX's resampler's fed those pairs, and the pairs are a
    one-process step's on the global batch with the same generators."""
    _, sd, _ = tiny
    p = payload(sd)
    a, b = ranks["ddp"]
    for (ta, la), (tb, lb) in zip(a["sampler_seen"], b["sampler_seen"]):
        assert ta.shape == (4,) and torch.equal(ta, tb) and torch.equal(la, lb)
    for k in ("loss_history", "loss_counts"):
        assert torch.equal(a["sampler_state"][k], b["sampler_state"][k])

    js = jresample.LossSecondMomentResampler.create(num_timesteps=STEPS, history=HISTORY)
    js = js.replace(loss_history=jnp.asarray(p["warm_sampler"]["loss_history"].numpy()),
                    loss_counts=jnp.asarray(p["warm_sampler"]["loss_counts"].numpy()))
    for t_seen, loss in a["sampler_seen"]:
        js = js.update(jnp.asarray(t_seen.numpy()), jnp.asarray(loss.numpy()))
    np.testing.assert_allclose(a["sampler_state"]["loss_history"].numpy(), np.asarray(js.loss_history))

    sampler = LossSecondMomentResampler(STEPS, history=HISTORY)
    sampler.load_state_dict(p["warm_sampler"])
    model = MultimodalUNet(configs.create_model_config(**TINY))
    model.load_state_dict(sd)
    state = create_train_state(model.train(), make_optimizer(model, LR), (0.5,), sampler=sampler)
    step = make_train_step(configs.create_gaussian_diffusion(steps=STEPS), shift=SHIFT)
    seen = []
    update = sampler.update
    sampler.update = lambda t, losses: seen.append((t.clone(), losses.clone())) or update(t, losses)
    t_gen, noise_gen = torch.Generator().manual_seed(11), torch.Generator().manual_seed(12)
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    for _ in range(SAMPLER_STEPS):
        step(state, batch, t_generator=t_gen, noise_generator=noise_gen)
    for (t_one, l_one), (t_ranks, l_ranks) in zip(seen, a["sampler_seen"]):
        assert torch.equal(t_one, t_ranks)
        torch.testing.assert_close(l_ranks, l_one, rtol=2e-5, atol=0)


# -- the mesh and bootstrap pieces ---------------------------------------------------


def test_param_spec_is_the_jax_rule():
    for shape in [(64, 32, 3, 3), (3, 3, 32, 64), (6, 10), (4, 4), (7, 9, 11), (1, 1024), (2, 512, 3)]:
        for n, lo in ((1, 0), (2, 16), (2, 10**6), (4, 8), (3, 1)):
            ref = jmesh.param_spec(np.zeros(shape, np.float32), n, lo)
            dim = param_spec(shape, n, lo)
            assert ref == (jmesh.P() if dim is None else jmesh.P(*["fsdp" if i == dim else None
                                                                     for i in range(len(shape))])), shape


def test_rank_rows_are_contiguous_rows_in_rank_order():
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(torch.cat([rank_rows(x, r, 3) for r in range(3)]), x)
    assert torch.equal(rank_rows(x, 1, 2), x[3:])
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(x, 0, 4)


def test_loop_seeds_never_meet_across_steps_and_ranks():
    """``TrainLoop._seed``: dropout's seed at (step, rank) is no other
    (step, rank)'s, nor a seed of the shared generators; those are alike on
    every rank and differ between runs' seeds."""
    def seeds(run_seed, step, rank):
        loop = types.SimpleNamespace(seed=run_seed, parallel=types.SimpleNamespace(rank=rank),
                                     t_generator=torch.Generator(), shift_generator=torch.Generator(),
                                     noise_generator=torch.Generator())
        TrainLoop._seed(loop, step)
        return (torch.initial_seed(), loop.t_generator.initial_seed(), loop.shift_generator.initial_seed(),
                loop.noise_generator.initial_seed())

    with torch.random.fork_rng(devices=[]):
        got = {(s, r): seeds(42, s, r) for s in range(400) for r in range(8)}
        other_run = seeds(43, 5, 0)
    dropout = [v[0] for v in got.values()]
    shared = {v[1:] for (s, r), v in got.items() if r == 0}
    assert all(v[1:] == got[s, 0][1:] for (s, r), v in got.items())
    assert len(set(dropout) | {x for v in shared for x in v}) == len(dropout) + 3 * len(shared)
    assert set(other_run).isdisjoint(got[5, 0])


def test_make_mesh_needs_a_process_group_for_more_than_one_process():
    assert not dist.is_initialized()
    assert make_mesh(n_fsdp=1, device_type="cpu") is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        make_mesh(n_fsdp=2, device_type="cpu")
    with pytest.raises(ValueError, match="positive"):
        make_mesh(n_fsdp=0, device_type="cpu")


def test_setup_dist_is_a_no_op_without_a_launcher(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert setup_dist("cpu") == torch.device("cpu") and not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")  # a world of one, without a rendezvous address
    assert setup_dist("cpu") == torch.device("cpu") and not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            setup_dist("cuda")


def test_setup_dist_raises_on_a_failed_rendezvous(monkeypatch):
    """An explicit launch whose rendezvous fails raises; it never falls
    back to one process (tests/test_bootstrap.py's contract)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]  # closed again: nobody listens there
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(Exception):
        setup_dist("cpu", timeout=datetime.timedelta(seconds=1))
    assert not dist.is_initialized()
