"""Port parity, checkpoints (repro_torch.checkpoint against
repro.checkpoint): atomic, async, retained, resumable, in the JAX
package's format.

The cases of tests/test_checkpoint.py on the port (restore onto a device
in place of reshard-on-load), plus interchange both ways: a tree one
package saves, the other restores ``array_equal`` — a float tree and a
``pack_tree`` artifact of the reduced internlm2 (the port's seeded
``init_lm`` packed by JAX's jitted ``symog_init`` + ``pack_tree``), and a
bfloat16 leaf — and the two packages write the same bytes for the same
tree (every ``.npy`` and the manifest)."""
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import load_pytree as jload  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, load_manifest, load_pytree  # noqa: E402
from repro_torch.checkpoint import save_pytree  # noqa: E402
from repro_torch.core import Packed  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths  # noqa: E402

_TREES = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree():
    g = torch.Generator().manual_seed(0)
    return {"a": {"kernel": torch.randn((8, 4), generator=g), "bias": torch.zeros(4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _np(leaf):
    if isinstance(leaf, Packed):
        return (leaf.data.numpy(), leaf.f.numpy(), leaf.n_bits)
    return leaf.numpy()


def _assert_trees_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = _np(x), _np(y)
        if isinstance(x, tuple):
            assert x[2] == y[2], path
            np.testing.assert_array_equal(x[0], y[0], err_msg=path)
            np.testing.assert_array_equal(x[1], y[1], err_msg=path)
        else:
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(x, y, err_msg=path)


def _reduced_trees():
    """(float jax tree, packed jax tree, float port tree, packed port tree)."""
    if not _TREES:
        own = init_lm(0, tconfigs.get_reduced("internlm2-1.8b"), device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jf = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own)
        st = jax.jit(lambda p: jcore.symog_init(p, scfg))(jf)
        jp = jax.jit(lambda p, s: jcore.pack_tree(p, s, scfg))(jf, st)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
        _TREES.update(jf=jf, jp=jp, tf=own, tp=tp)
    return _TREES


def test_roundtrip(tmp_path, tree):
    d = str(tmp_path / "ck")
    save_pytree(tree, d, metadata={"note": "x"})
    like = {"a": {"kernel": torch.empty((8, 4), device="meta"),
                  "bias": torch.empty(4, device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    _assert_trees_equal(load_pytree(d, like), tree)
    assert load_manifest(d)["metadata"] == {"note": "x"}


def test_atomic_no_partial_dirs(tmp_path, tree):
    save_pytree(tree, str(tmp_path / "ck"))
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_manager_retention_and_latest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, tree, blocking=True)
    assert mgr.steps() == [30, 40] and mgr.latest_step() == 40


def test_manager_keep_every(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=1, keep_every=20)
    for s in (10, 20, 30, 40, 50):
        mgr.save(s, tree, blocking=True)
    assert set(mgr.steps()) == {20, 40, 50}


def test_async_save_then_restore(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    before = tree["a"]["kernel"].clone()
    mgr.save(5, tree, metadata={"data": {"step": 5}})
    tree["a"]["kernel"].add_(1.0)  # the save snapshotted the tree before this
    mgr.wait()
    restored, meta, step = mgr.restore(tree)
    assert step == 5 and meta["data"]["step"] == 5
    np.testing.assert_array_equal(restored["a"]["kernel"].numpy(), before.numpy())


def test_restore_onto_device(tmp_path, tree):
    """Restore onto the engine's device (the port's counterpart of JAX's
    reshard-on-load): leaves land on ``device``, values unchanged."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    restored, _, _ = mgr.restore(tree, device=torch.device("cpu"))
    assert restored["a"]["kernel"].device == torch.device("cpu")
    _assert_trees_equal(restored, tree)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_shape_mismatch_raises(tmp_path, tree):
    d = str(tmp_path / "ck")
    save_pytree(tree, d)
    bad = {**tree, "a": {"kernel": torch.zeros((9, 4)), "bias": torch.zeros(4)}}
    with pytest.raises(ValueError, match="shape"):
        load_pytree(d, bad)


def test_missing_leaf_raises(tmp_path, tree):
    d = str(tmp_path / "ck")
    save_pytree(tree, d)
    with pytest.raises(KeyError):
        load_pytree(d, {**tree, "extra": torch.zeros(3)})


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_interchange_with_jax(tmp_path, kind):
    """JAX saves and the port restores array_equal; the port saves and JAX
    restores array_equal; both write the same files, byte for byte (a
    Packed leaf as JAX's pytree children ``<path>/0`` and ``<path>/1``)."""
    t = _reduced_trees()
    jtree, ttree = (t["jf"], t["tf"]) if kind == "float" else (t["jp"], t["tp"])
    jm, tm = JManager(str(tmp_path / "jax")), CheckpointManager(str(tmp_path / "port"))
    jm.save(3, jtree, metadata={"step": 3}, blocking=True)
    tm.save(3, ttree, metadata={"step": 3}, blocking=True)
    jd, td = jm.path(3), tm.path(3)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert filecmp.cmp(os.path.join(jd, name), os.path.join(td, name), shallow=False), name
    if kind == "packed":
        names = os.listdir(td)
        assert {"layers0__sub0__attn__q_proj__kernel__0.npy",
                "layers0__sub0__attn__q_proj__kernel__1.npy"} <= set(names)
    restored, meta, step = tm.restore(ttree)
    assert meta == {"step": 3} and step == 3
    back, _, _ = CheckpointManager(str(tmp_path / "jax")).restore(ttree)
    _assert_trees_equal(back, ttree)
    jback, _, _ = JManager(str(tmp_path / "port")).restore(jax.eval_shape(lambda: jtree))
    for a, b in zip(jax.tree_util.tree_leaves(jback), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bfloat16_leaf_matches_jax_bytes(tmp_path):
    w = torch.randn((3, 4), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    save_pytree({"w": w}, str(tmp_path / "port"))
    jsave({"w": jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)}, str(tmp_path / "jax"))
    for name in ("w.npy", "manifest.json"):
        assert filecmp.cmp(str(tmp_path / "port" / name), str(tmp_path / "jax" / name),
                           shallow=False)
    back = load_pytree(str(tmp_path / "jax"), {"w": w})["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, w)
