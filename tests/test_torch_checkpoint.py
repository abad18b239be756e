"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: every
case of ``tests/test_checkpoint.py`` against the port, and the files
crossing between the two packages in both directions.

The port keeps the reference's on-disk format, so a checkpoint written
by either package restores in the other, leaf for leaf and bit for bit:
the port flattens a nested state in ``jax.tree.flatten``'s order (dict
keys sorted, lists and tuples in order, a namedtuple by field, ``None``
no leaf), which the cross-package cases check with dict keys inserted
out of sorted order.
"""
import json
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointCorruptError as JaxCorruptError
from repro.checkpoint import load_checkpoint_arrays as jax_load
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro_torch.checkpoint import (CheckpointCorruptError, available_steps,
                                    latest_step, load_checkpoint_arrays,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import tree_flatten, tree_unflatten

CPU = dict(device="cpu")
Pair = namedtuple("Pair", "second first")


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((8, 16)).astype(np.float32)),
                       "b": torch.zeros((16,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(state):
    return [x.numpy() for x in tree_flatten(state)[0]]


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- the reference's cases, against the port -----------------------------------

def test_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, 7, state)
    restored, step = restore_checkpoint(tmp_path, state, **CPU)
    assert step == 7
    assert restored.keys() == state.keys()
    _assert_leaves_equal(_leaves(restored), _leaves(state))
    assert all(x.device.type == "cpu" for x in tree_flatten(restored)[0])


def test_latest_pointer_tracks_newest(tmp_path):
    save_checkpoint(tmp_path, 1, _state(1))
    save_checkpoint(tmp_path, 5, _state(2))
    assert latest_step(tmp_path) == 5
    restored, step = restore_checkpoint(tmp_path, _state(), **CPU)
    assert step == 5
    _assert_leaves_equal(_leaves(restored), _leaves(_state(2)))


def test_async_save_completes(tmp_path):
    state = _state()
    want = _leaves(state)
    want = [x.copy() for x in want]
    t = save_checkpoint(tmp_path, 3, state, async_=True)
    # the snapshot was taken before the call returned: writes to the
    # caller's tensors after it do not reach the file
    state["params"]["w"].add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    assert latest_step(tmp_path) == 3
    _, _, leaves = load_checkpoint_arrays(tmp_path)
    _assert_leaves_equal(leaves, want)


def test_corrupt_tmp_dir_never_published(tmp_path):
    save_checkpoint(tmp_path, 2, _state())
    # leftover tmp dirs (a crash mid-save) are invisible
    (tmp_path / ".tmp_step_000009_123").mkdir()
    assert latest_step(tmp_path) == 2


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, _state())
    bad_like = {"params": {"w": torch.zeros((4, 4)),
                           "b": torch.zeros((16,))},
                "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, bad_like, **CPU)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, [torch.zeros(3)], **CPU)


def test_manifest_records_structure(tmp_path):
    save_checkpoint(tmp_path, 4, _state())
    man = json.loads((tmp_path / "step_000004" / "manifest.json").read_text())
    assert man["step"] == 4
    # flat order: params.b, params.w, step; numpy's dtype names
    assert man["leaves"] == [{"shape": [16], "dtype": "float32"},
                             {"shape": [8, 16], "dtype": "float32"},
                             {"shape": [], "dtype": "int32"}]


def test_meta_roundtrips_through_manifest(tmp_path):
    meta = {"format": "test-v1", "shards_seen": [0, 2],
            "ewa": 1.25, "cache": [{"sid": 3, "ub_scale": 0.5}]}
    save_checkpoint(tmp_path, 2, _state(), meta=meta)
    step, manifest, leaves = load_checkpoint_arrays(tmp_path)
    assert step == 2
    assert manifest["meta"] == meta
    assert len(leaves) == 3
    # float64 leaves come back as host numpy, bit for bit
    save_checkpoint(tmp_path, 3, [np.array([1e-17, 1.0], np.float64)])
    _, _, (led,) = load_checkpoint_arrays(tmp_path)
    assert isinstance(led, np.ndarray)
    assert led.dtype == np.float64 and led[0] == 1e-17


def test_available_steps_lists_published_only(tmp_path):
    for s in (1, 9, 4):
        save_checkpoint(tmp_path, s, _state())
    (tmp_path / ".tmp_step_000077_1").mkdir()
    assert available_steps(tmp_path) == [1, 4, 9]
    assert available_steps(tmp_path / "absent") == []


def test_corrupt_latest_falls_back_to_previous_complete(tmp_path):
    save_checkpoint(tmp_path, 1, _state(1))
    save_checkpoint(tmp_path, 2, _state(2))
    # truncate the newest shard file: a torn/partial write
    (tmp_path / "step_000002" / "shard_0.npz").write_bytes(b"not an npz")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint_arrays(tmp_path)          # fallback off: rejected
    step, _, leaves = load_checkpoint_arrays(tmp_path, fallback=True)
    assert step == 1
    np.testing.assert_array_equal(leaves[1],
                                  _state(1)["params"]["w"].numpy())
    # the pytree-level restore takes the same fallback
    _, step = restore_checkpoint(tmp_path, _state(), fallback=True, **CPU)
    assert step == 1


def _tear_manifest(step_dir):
    (step_dir / "manifest.json").write_text("{ nope")


def _drop_shard(step_dir):
    (step_dir / "shard_0.npz").unlink()


@pytest.mark.parametrize("damage", [_tear_manifest, _drop_shard],
                         ids=["corrupt_manifest", "missing_shard_file"])
def test_damaged_newest_step_falls_back(tmp_path, damage):
    save_checkpoint(tmp_path, 3, _state(3))
    save_checkpoint(tmp_path, 6, _state(6))
    damage(tmp_path / "step_000006")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint_arrays(tmp_path)
    step, _, leaves = load_checkpoint_arrays(tmp_path, fallback=True)
    assert step == 3
    _assert_leaves_equal(leaves, _leaves(_state(3)))


def test_every_step_corrupt_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _state())
    (tmp_path / "step_000001" / "manifest.json").unlink()
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint_arrays(tmp_path, fallback=True)


def test_no_checkpoint_raises_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint_arrays(tmp_path / "empty")


# -- the port's own rules --------------------------------------------------------

def test_bf16_leaf_raises_type_error_naming_it(tmp_path):
    """bf16 leaves are stored as the reference stores them (their 16-bit
    words, manifest dtype "bfloat16") and come back bit for bit; a leaf
    of a dtype that numpy cannot hold (fp8) still raises ``TypeError``
    naming it, and publishes nothing."""
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    state = {"a": torch.zeros(2), "w": w.to(torch.bfloat16)}
    save_checkpoint(tmp_path / "bf16", 1, state)
    _, manifest, _ = load_checkpoint_arrays(tmp_path / "bf16")
    assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "bfloat16"]
    back, _ = restore_checkpoint(tmp_path / "bf16", state, **CPU)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       state["w"].view(torch.int16))
    bad = {"a": torch.zeros(2), "w": torch.zeros(3, dtype=torch.float8_e4m3fn)}
    with pytest.raises(TypeError, match=r"\['w'\].*float8"):
        save_checkpoint(tmp_path / "fp8", 1, bad)
    assert available_steps(tmp_path / "fp8") == []


def test_shardings_and_default_device(tmp_path):
    """``shardings=`` hands back DTensors in those placements (a world of
    one rank here; ``tests/test_torch_launch.py`` restores onto another
    mesh in a world of 8), and a sharded state saves the files the
    unsharded one does."""
    from repro_torch.core.distributed import one_rank_world
    from repro_torch.dtensor import is_dtensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import P, named
    save_checkpoint(tmp_path / "a", 1, _state())
    with one_rank_world("gloo"):
        sh = named(make_host_mesh(device="cpu"),
                   {"params": {"w": P("data", "model"), "b": P("model")},
                    "step": P()})
        back, step = restore_checkpoint(tmp_path / "a", _state(),
                                        shardings=sh, **CPU)
        leaves = tree_flatten(back)[0]
        assert step == 1 and all(is_dtensor(x) for x in leaves)
        assert back["params"]["w"].placements == sh["params"]["w"].placements
        _assert_leaves_equal([x.to_local().numpy() for x in leaves],
                             _leaves(_state()))
        save_checkpoint(tmp_path / "b", 1, back)
    _assert_leaves_equal(load_checkpoint_arrays(tmp_path / "b")[2],
                         load_checkpoint_arrays(tmp_path / "a")[2])
    if not torch.cuda.is_available():         # None means cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            restore_checkpoint(tmp_path, _state())


def test_flatten_order_is_jax_order():
    nested = {"z": 1, "a": [np.zeros(1), (2, None, Pair(3, 4))],
              "n": None, "m": {"y": 5, "b": 6}}
    leaves, treedef, paths = tree_flatten(nested)
    jleaves, _ = jax.tree.flatten(nested)
    assert [np.asarray(x).tolist() for x in leaves] == \
        [np.asarray(x).tolist() for x in jleaves]
    assert paths[-1] == "['z']" and paths[3] == "['a'][1][2].first"
    back = tree_unflatten(treedef, leaves)
    assert back["a"][1][2] == Pair(3, 4) and back["n"] is None
    assert list(back) == sorted(nested)


# -- across the packages --------------------------------------------------------

def _mixed(seed):
    """A nested dict/list/tuple/namedtuple/None state with f32, f64,
    i32, i64 and bool leaves, dict keys inserted out of sorted order."""
    rng = np.random.default_rng(seed)
    return {
        "zeta": rng.standard_normal((3, 4)).astype(np.float32),
        "beta": [rng.standard_normal(5).astype(np.float64),
                 (rng.integers(-9, 9, 6).astype(np.int32), None,
                  Pair(rng.random(4) < 0.5,
                       rng.integers(0, 1 << 40, 3).astype(np.int64)))],
        "alpha": {"y": np.float32(2.5) * np.ones((2,), np.float32),
                  "b": np.arange(7, dtype=np.int64)},
        "none": None,
    }


def _as_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pytree_crosses_packages(tmp_path, writer):
    state = _mixed(1)
    want, treedef = jax.tree.flatten(state)
    if writer == "jax":
        jax_save(tmp_path, 5, state)
    else:
        save_checkpoint(tmp_path, 5, _as_torch(state))
    # the port reads it into its structure, every dtype kept
    got, step = restore_checkpoint(tmp_path, _as_torch(_mixed(2)), **CPU)
    assert step == 5
    assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got)) == \
        treedef
    _assert_leaves_equal([x.numpy() for x in tree_flatten(got)[0]], want)
    # JAX reads it: raw leaves bit for bit, and its pytree restore into
    # the same structure (x64 is off there: f64/i64 arrive as 32-bit)
    _, jman, jleaves = jax_load(tmp_path)
    _assert_leaves_equal(jleaves, want)
    _, man, _ = load_checkpoint_arrays(tmp_path)
    assert man == jman
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        state)
    jgot, _ = jax_restore(tmp_path, like)
    assert jax.tree.structure(jgot) == treedef
    for a, b in zip(jax.tree.leaves(jgot), want):
        assert a.shape == b.shape
        if a.dtype == b.dtype:
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_step_falls_back_in_the_other_package(tmp_path, writer):
    s1, s2 = _mixed(1), _mixed(2)
    for step, st in ((1, s1), (2, s2)):
        if writer == "jax":
            jax_save(tmp_path, step, st)
        else:
            save_checkpoint(tmp_path, step, _as_torch(st))
    (tmp_path / "step_000002" / "shard_0.npz").write_bytes(b"torn write")
    load, corrupt = (load_checkpoint_arrays, CheckpointCorruptError) \
        if writer == "jax" else (jax_load, JaxCorruptError)
    with pytest.raises(corrupt):
        load(tmp_path)
    step, _, leaves = load(tmp_path, fallback=True)
    assert step == 1
    _assert_leaves_equal(leaves, jax.tree.leaves(s1))


def test_jax_arrays_and_port_tensors_write_the_same_files(tmp_path):
    """The reference's own state (jax arrays) and its port twin give the
    same manifest and the same leaves."""
    key = jax.random.PRNGKey(0)
    jstate = {"params": {"w": jax.random.normal(key, (8, 16)),
                         "b": jnp.zeros((16,))}, "step": jnp.int32(7)}
    jax_save(tmp_path / "j", 7, jstate)
    save_checkpoint(tmp_path / "t", 7, jax.tree.map(
        lambda x: torch.from_numpy(np.asarray(x).copy()), jstate))
    jm = (tmp_path / "j" / "step_000007" / "manifest.json").read_text()
    tm = (tmp_path / "t" / "step_000007" / "manifest.json").read_text()
    assert jm == tm
    _assert_leaves_equal(load_checkpoint_arrays(tmp_path / "j")[2],
                         load_checkpoint_arrays(tmp_path / "t")[2])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_train_state_crosses_packages(tmp_path, writer):
    """A train state JAX wrote restores into the port's placements, and a
    sharded state the port wrote is JAX's files (a world of one rank
    here: the slicing itself is held on 8 ranks in
    ``tests/test_torch_launch.py``)."""
    from repro.configs import get_config as jax_config
    from repro.train.steps import init_train_state as jax_init_state
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.core.distributed import one_rank_world
    from repro_torch.dtensor import is_dtensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (named, shard_tree,
                                             train_state_pspecs)
    jstate = jax_init_state(jax.random.PRNGKey(3),
                            jax_config("hymba-1.5b").reduced())
    cfg = get_config("hymba-1.5b").reduced()
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   **CPU)
    want = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    with one_rank_world("gloo"):
        sh = named(make_host_mesh(device="cpu"), train_state_pspecs(cfg))
        if writer == "jax":
            jax_save(tmp_path, 3, jstate)
            got, step = restore_checkpoint(tmp_path, state, shardings=sh,
                                           **CPU)
            leaves = tree_flatten(got)[0]
            assert step == 3 and all(is_dtensor(x) for x in leaves)
            _assert_leaves_equal([x.to_local().numpy() for x in leaves],
                                 want)
        else:
            save_checkpoint(tmp_path, 3, shard_tree(state, sh))
    if writer == "port":
        _assert_leaves_equal(jax_load(tmp_path)[2], want)
        like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jstate)
        jgot, step = jax_restore(tmp_path, like)
        assert step == 3
        _assert_leaves_equal([np.asarray(x) for x in jax.tree.leaves(jgot)],
                             want)
