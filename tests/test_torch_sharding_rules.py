"""Port parity, sharding rules and placement (in-process, no ranks):

  * ``ShardingRules.pspec_for`` equals JAX's ``PartitionSpec`` at every leaf
    of all 10 reduced configs' float and ``pack_tree`` trees (JAX's leaf
    paths and shapes from ``jax.eval_shape``; a ``Packed`` leaf as its
    ``<path>/0`` words and ``<path>/1`` exponent), under every profile, on
    (1, 1), (2, 4), (4, 2) and (2, 2, 2) with ``pod`` (JAX's
    ``AbstractMesh``); the port's own trees give the same paths;
  * ``act_pspec``; ``pool_head_shards`` / ``pool_pspec``, and
    ``pool_bytes_per_device(model_shards=2, 4)`` for bf16, ``int8_fp`` and
    ``int4_fp`` pools against JAX's engines;
  * ``reshard_plan`` and the ``launch/shardings`` specs against the
    ``.spec`` of JAX's shardings (a concrete (1, 1) mesh where
    ``NamedSharding`` refuses an abstract one);
  * ``Mesh`` of one rank: coordinates, groups, ``current_mesh``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import optim as j_optim  # noqa: E402
from repro.distributed import reshard_plan as j_reshard_plan  # noqa: E402
from repro.launch import shardings as jshard  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.nn import sharding as jrules  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import sharding as jserve_sharding  # noqa: E402
from repro.train import init_train_state as j_init_train_state  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.distributed import reshard_plan  # noqa: E402
from repro_torch.launch import shardings as tshard  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.models.lm import init_caches  # noqa: E402
from repro_torch.nn import sharding as trules  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve import sharding as tserve_sharding  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _jax_shapes(arch):
    """{'float' | 'packed': [(path, shape)]} of JAX's reduced trees, by
    ``eval_shape`` (nothing materialised)."""
    cfg = jconfigs.get_reduced(arch)
    scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
    fl = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), cfg))

    def packed():
        p = j_init(jax.random.PRNGKey(0), cfg)
        return jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg)

    pk = jax.eval_shape(packed)
    return {k: [(path, tuple(x.shape)) for path, x in j_flatten(t)]
            for k, t in (("float", fl), ("packed", pk))}


def _port_trees(arch):
    """The same trees of the port (its own seeded init and pack_tree)."""
    cfg = tconfigs.get_reduced(arch)
    p = init_lm(0, cfg, device="cpu")
    scfg = tcore.SymogConfig(n_bits=2, total_steps=1)
    return {"float": p, "packed": tcore.pack_tree(p, tcore.symog_init(p, scfg), scfg)}


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_pspec_for_matches_jax_on_every_leaf(arch):
    shapes = _jax_shapes(arch)
    port_trees = _port_trees(arch)
    for shape, names in MESHES:
        jmesh = AbstractMesh(shape, names)
        tmesh = trules.AbstractMesh(shape, names)
        for profile in trules.PROFILES:
            jr, tr = jrules.make_rules(jmesh, profile), trules.make_rules(tmesh, profile)
            assert tr.axis_map == {k: (tuple(v) if isinstance(v, list) else v)
                                   for k, v in jr.axis_map.items()}, (shape, profile)
            for kind, rows in shapes.items():
                want = {path: tuple(jr.pspec_for(path, s)) for path, s in rows}
                for path, s in rows:
                    assert tr.pspec_for(path, s) == want[path], (arch, kind, shape, profile, path)
                # the port's own tree: the same leaves, paths and specs
                specs = trules.pspec_tree_for_params(tr, port_trees[kind])
                assert dict(_flat_specs(specs)) == want, (arch, kind, shape, profile)


def _flat_specs(tree, prefix=""):
    """(path, spec) over a spec tree, a PackedSpec as <path>/0, <path>/1."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_specs(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, trules.PackedSpec):
        yield f"{prefix}/0", tree.words
        yield f"{prefix}/1", tree.f
    else:
        yield prefix, tree


@pytest.mark.parametrize("kind", ["btd", "bt", "btv"])
def test_act_pspec_matches_jax(kind):
    for shape, names in MESHES:
        for profile in trules.PROFILES:
            jr = jrules.make_rules(AbstractMesh(shape, names), profile)
            tr = trules.make_rules(trules.AbstractMesh(shape, names), profile)
            assert tr.act_pspec(kind) == tuple(jr.act_pspec(kind)), (shape, profile)


def test_pool_head_shards_and_pspec_match_jax():
    for shape, names in MESHES:
        for profile in trules.PROFILES:
            jr = jrules.make_rules(AbstractMesh(shape, names), profile)
            tr = trules.make_rules(trules.AbstractMesh(shape, names), profile)
            for leaf, axis in (((9, 16, 2, 8), 0), ((9, 16, 4, 8), 0), ((9, 16, 8, 8), 0),
                               ((3, 9, 16, 4, 8), 1), ((9, 16, 7), 0), ((3, 9, 16, 7), 1)):
                assert (tserve_sharding.pool_head_shards(tr, leaf, axis)
                        == jserve_sharding.pool_head_shards(jr, leaf, axis)), (shape, leaf)
                assert (tserve_sharding.pool_pspec(tr, leaf, axis)
                        == tuple(jserve_sharding.pool_pspec(jr, leaf, axis))), (shape, leaf)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("kv", ["bf16", "int8_fp", "int4_fp"])
def test_pool_bytes_per_device_matches_jax(arch, kv):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_cache_dtype=kv)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), kv_cache_dtype=kv)
    own = init_lm(0, tcfg, device="cpu")
    jeng = JEngine(jcfg, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own),
                   max_len=32, compute_dtype=jnp.float32)
    teng = ServeEngine(tcfg, own, max_len=32, compute_dtype=torch.float32, device="cpu")
    for m in (0, 2, 4):
        for blocks in (8, 33):
            assert (tserve_sharding.pool_bytes_per_device(teng, 16, blocks, model_shards=m)
                    == tuple(jserve_sharding.pool_bytes_per_device(jeng, 16, blocks,
                                                                   model_shards=m))), (m, blocks)


def _spec_of(named):
    return tuple(named.spec)


def test_reshard_plan_and_launch_specs_match_jax():
    cfg = tconfigs.get_reduced("internlm2-1.8b")
    own = init_lm(0, cfg, device="cpu")
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    scfg = tcore.SymogConfig(n_bits=2, total_steps=1)
    state = init_train_state(own, tx, scfg)
    jtx = j_optim.chain(j_optim.clip_by_global_norm(1.0),
                        j_optim.sgd(momentum=0.9, nesterov=True))
    jstate = j_init_train_state(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own),
                                jtx, jcore.SymogConfig(n_bits=2, total_steps=1))
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = trules.AbstractMesh((1, 1), ("data", "model"))
    want = {p: _spec_of(s) for p, s in j_flatten(j_reshard_plan(jstate, jmesh, "fsdp_tp"))}
    got = dict(_flat_state(reshard_plan(state, tmesh, "fsdp_tp")))
    assert got == want
    # and on a wider abstract mesh, where the rules split leaves
    amesh, tmesh4 = AbstractMesh((2, 4), ("data", "model")), trules.AbstractMesh((2, 4),
                                                                                ("data", "model"))
    jr = jrules.make_rules(amesh, "fsdp_tp")
    want = {p: tuple(jr.pspec_for(p, x.shape)) for p, x in j_flatten(jstate)}
    assert dict(_flat_state(tshard.state_shardings(state, tmesh4, "fsdp_tp"))) == want
    # batch and cache specs
    jcfg = jconfigs.get_reduced("internlm2-1.8b")
    batch = {"tokens": np.zeros((4, 8), np.int32)}
    assert ({p: s for p, s in _flat_dict(tshard.data_shardings(batch, tmesh))}
            == {p: _spec_of(s) for p, s in j_flatten(jshard.data_shardings(batch, jmesh))})
    caches = init_caches(cfg, 4, 16, torch.float32, device="meta")
    jcaches = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32), caches)
    assert ({p: s for p, s in _flat_dict(tshard.cache_shardings(caches, cfg, tmesh))}
            == {p: _spec_of(s) for p, s in j_flatten(jshard.cache_shardings(jcaches, jcfg,
                                                                              jmesh))})
    pw = {p: _spec_of(s) for p, s in j_flatten(jshard.param_shardings(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own), jcfg, jmesh))}
    assert dict(_flat_dict(tshard.param_shardings(own, cfg, tmesh))) == pw


def _flat_dict(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_dict(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _flat_state(state):
    """(path, spec) over a TrainState's spec tree, JAX's path names."""
    for field, sub in zip(state._fields, state):
        if field == "symog":
            yield from _flat_dict(sub.f, "symog/0")
        elif field == "step":
            yield "step", sub
        elif isinstance(sub, tuple):
            for i, part in enumerate(sub):
                if isinstance(part, dict):
                    yield from _flat_dict(part, f"{field}/{i}")
                elif isinstance(part, tuple) and hasattr(part, "_fields"):
                    for f2, v in zip(part._fields, part):
                        yield from _flat_dict(v, f"{field}/{i}/{f2}")
        else:
            yield from _flat_dict(sub, field)


def test_one_rank_mesh():
    mesh = trules.Mesh((1, 1), ("data", "model"))
    assert mesh.rank == 0 and mesh.coords == {"data": 0, "model": 0}
    assert mesh.group("model") is None and mesh.axis_index(("data", "model")) == 0
    assert trules.current_mesh() is None
    with mesh:
        assert trules.current_mesh() is mesh
    assert trules.current_mesh() is None
    assert trules.mesh_axis_size(mesh, "model", "pod") == 1
    with pytest.raises(ValueError, match="needs 4 ranks"):
        trules.Mesh((2, 2), ("data", "model"))
