"""The port's sharded train state, launcher, dry run and LM example
(``repro_torch.launch``, ``train.make_sharded_train_step``,
``repro_torch.examples.train_lm``) against the JAX package's, on the
CPU.

* One world of 8 ``gloo`` ranks (``spawn_world``; the ranks' side is
  ``tests/_torch_world.py::sharded_train_world``) steps reduced
  qwen2-7b and hymba-1.5b on mesh (4, 2) from JAX's initial state
  (``convert.train_state_from_numpy``) for three steps: each loss
  within 2e-3 (the reference test's bound, relative) of JAX's unsharded
  ``make_train_step`` on the same state and batches and of the port's
  unsharded step, ``grad_norm`` within 1e-4 of the port's unsharded one
  (fp32 gradients averaged over 4 ranks against one autograd pass);
  the full parameters and moments after steps 1 and 3 against both
  unsharded states (``GAP_P``, ``GAP_M``);
  the same step twice the same bits; every shard the shape DTensor
  gives; an elastic restore from mesh (8, 1) onto (2, 4) and a replay
  through ``ResilientLoop(state_shardings=...)`` bit for bit.
* The launcher as a process, reduced musicgen-medium on the CPU, in a
  world of 1 and of 2; ``examples.train_lm --tiny``.
* The dry run: the FLOP count of a reduced cell on ``meta`` tensors
  equals the count of the same step on real CPU tensors.
"""
import os
import subprocess
import sys

import _torch_world
import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_config
from repro.train.steps import init_train_state as jax_init_state
from repro.train.steps import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.distributed import spawn_world
from repro_torch.data import TokenPipeline
from repro.configs import list_configs
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import AbstractMesh, production_shape
from repro_torch.models import init_cache, init_params
from repro_torch.train import (loss_and_grads, make_prefill_step,
                               make_serve_step, make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2-7b", "hymba-1.5b"]
# the sharded state's gap to an unsharded one after steps 1 and 3, from
# the gaps measured on the CPU (fp32, reduced configs): parameter
# updates 1.9e-5..1.0e-3 from the port's and up to 5.4e-3 from JAX's,
# moments 3.1e-7..7.5e-7 from the port's and up to 2.0e-6 from JAX's
GAP_P, GAP_M = 2e-2, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work (and its
    processes'): the suite runs several workers at once, and the tiny
    steps here only slow down when their threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _full(state) -> dict:
    """The full leaves of a port state's params, m and v, in
    ``tree_flatten``'s order."""
    return {k: tree_flatten(getattr(state, k))[0] for k in ("params", "m",
                                                            "v")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world's reports, and JAX's and the port's unsharded
    metrics and states after steps 1 and 3 on the same states and
    batches."""
    pipe = TokenPipeline(get_config("qwen2-7b").reduced(), 8, 32, seed=0)
    batches = [pipe.global_batch(i) for i in range(3)]
    states, want = {}, {}
    for arch in ARCHS:
        jcfg = jax_config(arch).reduced()
        jstate = jax_init_state(jax.random.PRNGKey(0), jcfg)
        np_state = jax.tree.map(np.asarray, jstate)
        states[arch] = dict(step=np_state.step, params=np_state.params,
                            m=np_state.m, v=np_state.v)
        cfg = get_config(arch).reduced()
        pstate = train_state_from_numpy(np_state, cfg, device="cpu")
        jstep, pstep = jax.jit(jax_train_step(jcfg)), make_train_step(cfg)
        got = dict(jax=[], port=[], port_norm=[], jax_full={}, port_full={},
                   init=_full(pstate))
        for i, batch in enumerate(batches):
            jstate, jm = jstep(jstate, batch)
            pstate, pm = pstep(pstate, batch)
            got["jax"].append(float(jm["loss"]))
            got["port"].append(float(pm["loss"]))
            got["port_norm"].append(float(pm["grad_norm"]))
            if i + 1 in (1, 3):
                got["port_full"][i + 1] = _full(pstate)
                got["jax_full"][i + 1] = _full(train_state_from_numpy(
                    jax.tree.map(np.asarray, jstate), cfg, device="cpu"))
        want[arch] = got
    ranks = spawn_world(_torch_world.sharded_train_world, 8,
                        args=(states, batches,
                              str(tmp_path_factory.mktemp("w"))),
                        timeout=300)
    return ranks, want


def _gap(got, want, base=None) -> float:
    """The largest, over the leaves, of ``|got - want| / |want - base|``
    (``base`` None: ``/ |want|``), in Frobenius norms and float64: a
    moment's relative error, or a parameter update's."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.double(), w.double()
        ref = w if base is None else w - base[i].double()
        worst = max(worst, float(torch.linalg.vector_norm(g - w) /
                                 torch.linalg.vector_norm(ref)))
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded(world, arch):
    ranks, want = world
    got, want = ranks[0][arch], want[arch]
    assert got["loss"] == pytest.approx(want["jax"][0], rel=2e-3)
    assert got["losses"] == pytest.approx(want["jax"], rel=2e-3)
    assert got["losses"] == pytest.approx(want["port"], rel=2e-3)
    assert got["grad_norms"] == pytest.approx(want["port_norm"], rel=1e-4)
    # every rank reports the same losses, bit for bit
    assert all(r[arch] == got["losses"] for r in ranks[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_matches_unsharded(world, arch):
    """The full parameters and moments after steps 1 and 3 against the
    port's and JAX's unsharded steps: each moment leaf within GAP_M of
    theirs, each parameter leaf's change from the initial state within
    GAP_P of theirs (relative, Frobenius). A gradient shard matched to
    another parameter's shard, or moments placed on the wrong shard,
    is off by about 1."""
    ranks, want = world
    got, want = ranks[0][arch]["full"], want[arch]
    for n in (1, 3):
        for ref in (want["port_full"][n], want["jax_full"][n]):
            gaps = {k: _gap(got[n][k], ref[k],
                            want["init"]["params"] if k == "params"
                            else None) for k in ("params", "m", "v")}
            assert gaps["params"] <= GAP_P and gaps["m"] <= GAP_M \
                and gaps["v"] <= GAP_M, (n, gaps)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_repeats_and_shards_as_placed(world, arch):
    got = world[0][0][arch]
    assert got["repeat"] and got["shapes_ok"] and got["step"] == 1
    # embed (vocab 256, d 64) under P("model", "data") on (4, 2): vocab
    # over "model" (2), d_model over "data" (4)
    assert got["local_embed"] == (128, 16)


def test_gather_of_uneven_shards_is_bit_for_bit(world):
    """``gather_full`` (every rank) and ``gather_to_root`` (rank 0) of
    shards cut by ``torch.chunk``'s rule on mesh (4, 2): short and empty
    trailing shards, two mesh dimensions on one tensor dimension, bf16."""
    assert world[0][0]["gather"] == [True] * 4


def test_elastic_restore_onto_another_mesh_is_bit_for_bit(world):
    got = world[0][0]["elastic"]
    assert got["bits"] and got["shapes_ok"] and got["has"]
    assert got["step"] == 1 and got["mesh"] == (2, 4)


def test_resilient_replay_with_state_shardings_is_bit_for_bit(world):
    got = world[0][0]["replay"]
    assert got["restarts"] == 1 and got["bits"] and got["shapes_ok"]
    assert got["step"] == 4 and got["leftovers"] == []
    assert got["losses"][-2:] == got["clean_losses"][-2:]


def _launch(tmp_path, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "musicgen-medium", "--reduced", "--steps", "6", "--batch", "2",
         "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         *extra],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("world_size", [1, 2])
def test_train_launcher_cli(tmp_path, world_size):
    stdout = _launch(tmp_path, "--world", str(world_size), "--fail-at", "3")
    assert "loss" in stdout and "restarts=1" in stdout
    assert stdout.count("[train]") == 2         # rank 0 alone prints


@pytest.mark.parametrize("env, cards, device, want", [
    # two machines of 8 cards, 8 ranks each: every rank has its card
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "5"}, 8,
     None, (5, 8, "nccl")),
    # 16 ranks on one machine of 8 cards share them
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "16", "LOCAL_RANK": "9"}, 8,
     None, (9, 16, "gloo")),
    # no LOCAL_WORLD_SIZE: the world is on this machine
    ({"WORLD_SIZE": "4"}, 8, None, (0, 4, "nccl")),
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8"}, 8, "cpu",
     (0, 8, "gloo")),
])
def test_launcher_backend_under_torchrun(monkeypatch, env, cards, device,
                                         want):
    """NCCL where each of this machine's ranks has a card, whatever the
    world's size across machines; gloo for the CPU or shared cards."""
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    local, here = launch_train._torchrun_ranks(env)
    assert (local, here, launch_train._backend(device, here)) == want


def test_train_lm_example_learns(tmp_path):
    from repro_torch.examples.train_lm import main
    loop = main(["--tiny", "--steps", "40", "--batch", "4", "--seq", "64",
                 "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in loop.metrics_log]
    assert len(losses) == 40 and losses[-1] < 0.7 * losses[0]


def _real_flops(cfg, kind, batch, seq):
    """The FLOPs of ``kind``'s step on real CPU tensors."""
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (batch, seq), dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter:
        if kind == "train":
            loss_and_grads(params, {"tokens": tokens, "labels": tokens}, cfg)
        elif kind == "prefill":
            make_prefill_step(cfg)(params, {"tokens": tokens})
        else:
            make_serve_step(cfg)(params, init_cache(cfg, batch, seq,
                                                    device="cpu"),
                                 tokens[:, :1], seq - 1)
    return counter.get_total_flops()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_meta_flops_equal_real_cpu_flops(shape):
    cfg, info = specs.reduced_cell(get_config("hymba-1.5b"), shape)
    one = AbstractMesh((1, 1), ("data", "model"))
    cost = dryrun.cell_cost(cfg, info["kind"], info["batch"], info["seq"],
                            one)
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert cost["coll"] == 0
    assert cost["flops"] == _real_flops(cfg, info["kind"], info["batch"],
                                        info["seq"])
    # on (4, 2) a rank computes a quarter of the rows
    four = dryrun.cell_cost(cfg, info["kind"], info["batch"], info["seq"],
                            AbstractMesh((4, 2), ("data", "model")))
    assert four["memory_bytes"] < cost["memory_bytes"]
    if info["kind"] != "decode":
        assert four["flops"] < cost["flops"]


@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_are_meta_for_every_cell(arch):
    """Every cell's inputs at full size on both production meshes are
    ``meta`` tensors (nothing allocated), with one spec a leaf, each
    spec no longer than its tensor, the state's shapes the model's."""
    cfg = get_config(arch)
    for multi in (False, True):
        mesh = production_shape(multi)
        for shape in specs.SHAPES:
            args, in_specs, _, kind = specs.input_specs(cfg, shape, mesh)
            pairs = dryrun._pairs(args, in_specs)
            assert kind == specs.SHAPES[shape]["kind"]
            assert len(pairs) == len(tree_flatten(args)[0])
            for t, spec in pairs:
                assert t.device.type == "meta" and len(spec) <= t.dim()
    state = specs.meta_train_state(cfg)
    assert [tuple(t.shape) for t in tree_flatten(state.params)[0]] == \
        [tuple(t.shape) for t in tree_flatten(state.m)[0]]
