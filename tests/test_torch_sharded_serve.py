"""Port parity, sharded serving on ``torch.distributed`` (gloo ranks on the
CPU; the contracts of tests/test_sharded_serve.py):

  * greedy ``serve()`` on a (1, 2) mesh is TOKEN-IDENTICAL to the port's
    1-rank serve for internlm2, gemma2 and granite, ``quantize_tree`` and
    ``pack_tree`` artifacts alike (granite's one KV head keeps its attention
    replicated), and for internlm2 to JAX's single-device serve;
  * ``int8_fp`` / ``int4_fp`` pools shard their KV heads (each rank's pool
    leaves hold K/m heads, their exponents co-sharded with them), block
    tables replicated, streams unchanged;
  * at m = 4 the 2 KV heads do not divide: attention and its pool
    replicate (the rules' fallback), streams unchanged;
  * olmoe and deepseek at ``moe_impl='ep'`` decode expert-parallel under
    the scheduler (``capabilities()['ep_moe']`` on the mesh, not off it),
    token-identical to the 1-rank capacity dispatch;
  * a family with no tensor-parallel form (mamba2) is refused on a model
    axis > 1, naming the ROADMAP item.

Each world's ranks are spawned once (a module fixture; JAX references in
this process, never in the ranks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.nn.sharding import Mesh, current_mesh  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402
from torch_dist_ranks import run_ranks, serve_jobs  # noqa: E402

MAX_LEN = 32
DENSE = ("internlm2-1.8b", "gemma2-27b", "granite-34b")
MOE = ("olmoe-1b-7b", "deepseek-v3-671b")


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=L).astype(np.int32), b)
            for L, b in zip((3, 6, 4, 7), (6, 3, 5, 2))]


def _one_rank(cfg, tree, reqs):
    eng = ServeEngine(cfg, tree, max_len=MAX_LEN, compute_dtype=torch.float32, device="cpu")
    comps = eng.serve([Request(tokens=t, max_new_tokens=b) for t, b in reqs],
                      ServeConfig(n_slots=2, temperature=0.0))
    return [list(map(int, c.tokens)) for c in comps], eng


def _port_trees(cfg):
    p = init_lm(0, cfg, device="cpu")
    scfg = tcore.SymogConfig(n_bits=2, total_steps=1)
    st = tcore.symog_init(p, scfg)
    return {"qt": tcore.quantize_tree(p, st, scfg), "pt": tcore.pack_tree(p, st, scfg)}


def _jax_trees(arch):
    """internlm2's artifacts: the port's seeded init carried into JAX arrays,
    JAX's jitted symog_init + quantize_tree / pack_tree, and the port's
    trees of the same words through numpy."""
    own = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
    jf = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own)
    scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
    st = jax.jit(lambda p: jcore.symog_init(p, scfg))(jf)
    out = {}
    for kind, fn in (("qt", jcore.quantize_tree), ("pt", jcore.pack_tree)):
        jt = jax.jit(lambda p, s, fn=fn: fn(p, s, scfg))(jf, st)
        out[kind] = (jt, params_from_numpy(jax.tree_util.tree_map(np.asarray, jt)))
    return out


@pytest.fixture(scope="module")
def served():
    """{job: (1-rank tokens, [rank results], extra)} for the world-2 jobs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jobs, ref, extra = [], {}, {}
    for arch in DENSE:
        cfg = tconfigs.get_reduced(arch)
        reqs = _requests(cfg.vocab_size)
        if arch == "internlm2-1.8b":
            # JAX's engine serves a packed artifact densified (exact): its
            # quantize_tree serve is the stream both port artifacts must give
            trees = _jax_trees(arch)
            jeng = JEngine(jconfigs.get_reduced(arch), trees["qt"][0], max_len=MAX_LEN,
                           compute_dtype=jnp.float32)
            jc = jeng.serve([JRequest(tokens=t, max_new_tokens=b) for t, b in reqs],
                            JServeConfig(n_slots=2, temperature=0.0))
            extra["jax"] = [list(map(int, c.tokens)) for c in jc]
            trees = {k: v[1] for k, v in trees.items()}
        else:
            trees = _port_trees(cfg)
        for kind, tree in trees.items():
            name = f"{arch}/{kind}"
            ref[name] = _one_rank(cfg, tree, reqs)[0]
            jobs.append(dict(name=name, cfg=cfg, params=tree, mesh=(1, 2), max_len=MAX_LEN,
                             requests=reqs))
    for kv in ("int8_fp", "int4_fp"):
        cfg = dataclasses.replace(tconfigs.get_reduced("internlm2-1.8b"), kv_cache_dtype=kv)
        p = init_lm(0, cfg, device="cpu")
        reqs = _requests(cfg.vocab_size)
        name = f"pool/{kv}"
        ref[name], eng = _one_rank(cfg, p, reqs)
        comps, sched = eng.serve([Request(tokens=t, max_new_tokens=b) for t, b in reqs],
                                 ServeConfig(n_slots=2, temperature=0.0), return_scheduler=True)
        extra[name] = {f"{gn}/{sn}/{ln}": leaf.clone() for gn, g in sched.caches.items()
                       for sn, sub in g.items() for ln, leaf in sub.items()
                       if ln.endswith("_scale")}
        jobs.append(dict(name=name, cfg=cfg, params=p, mesh=(1, 2), max_len=MAX_LEN,
                         requests=reqs))
    for arch in MOE:
        cfg = dataclasses.replace(tconfigs.get_reduced(arch), moe_impl="ep")
        p = init_lm(0, cfg, device="cpu")
        reqs = _requests(cfg.vocab_size)
        name = f"ep/{arch}"
        ref[name], eng = _one_rank(cfg, p, reqs)
        extra[name] = eng.capabilities()["ep_moe"]
        jobs.append(dict(name=name, cfg=cfg, params=p, mesh=(1, 2), max_len=MAX_LEN,
                         requests=reqs))
    cfg = tconfigs.get_reduced("mamba2-2.7b")
    ref["refuse/mamba2"] = None
    jobs.append(dict(name="refuse/mamba2", cfg=cfg, params=init_lm(0, cfg, device="cpu"),
                     mesh=(1, 2), max_len=MAX_LEN, refused=True))
    torch.set_num_threads(n)
    ranks = run_ranks(serve_jobs, 2, {"jobs": jobs})
    return {name: (ref[name], [r[name] for r in ranks]) for name in ref}, extra


@pytest.fixture(scope="module")
def fallback():
    """internlm2 (2 KV heads) on a (1, 4) mesh: world 4."""
    cfg = tconfigs.get_reduced("internlm2-1.8b")
    tree = _port_trees(cfg)["pt"]
    reqs = _requests(cfg.vocab_size)
    ref = _one_rank(cfg, tree, reqs)[0]
    ranks = run_ranks(serve_jobs, 4, {"jobs": [dict(name="m4", cfg=cfg, params=tree,
                                                     mesh=(1, 4), max_len=MAX_LEN,
                                                     requests=reqs)]})
    return ref, [r["m4"] for r in ranks]


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_serve_token_identical(served, arch):
    jobs, _ = served
    for kind in ("qt", "pt"):
        ref, ranks = jobs[f"{arch}/{kind}"]
        for r in ranks:
            assert r["model_shards"] == 2
            assert r["tokens"] == ref, (arch, kind)
        assert ranks[0]["plan"]["mlp"] and ranks[0]["plan"]["embed"]
        # granite's single KV head cannot split: its attention replicates
        assert ranks[0]["plan"]["attn"] == (arch != "granite-34b")


@pytest.mark.parametrize("kind", ["qt", "pt"])
def test_sharded_internlm2_matches_jax_serve(served, kind):
    jobs, extra = served
    ref, ranks = jobs[f"internlm2-1.8b/{kind}"]
    assert ref == extra["jax"]
    assert all(r["tokens"] == extra["jax"] for r in ranks)


@pytest.mark.parametrize("kv", ["int8_fp", "int4_fp"])
def test_quantized_pool_shards_kv_heads(served, kv):
    jobs, extra = served
    ref, ranks = jobs[f"pool/{kv}"]
    cfg = tconfigs.get_reduced("internlm2-1.8b")
    K = cfg.n_kv_heads
    for r in ranks:
        assert r["tokens"] == ref
        assert r["pools"]
        for shape in r["pools"].values():
            assert shape[-2] * 2 == K  # K/m heads of every physical block
        assert r["local_heads"] == (cfg.n_heads // 2, K // 2)
        total, per_dev = r["pool_bytes"]
        scale = sum(t.numel() * 4 for t in r["scales"].values())
        # data leaves divided by the shards; the exponents, counted
        # replicated by JAX's accounting, are co-sharded with their heads
        assert r["paged_pool_bytes"] == per_dev - scale
        assert total - (2 * scale) == 2 * (per_dev - 2 * scale)
    # tables replicated; each rank's exponents are its heads' of the 1-rank pool
    assert torch.equal(ranks[0]["block_tables"], ranks[1]["block_tables"])
    for key, full in extra[f"pool/{kv}"].items():
        both = torch.cat([ranks[0]["scales"][key], ranks[1]["scales"][key]], dim=-1)
        assert torch.equal(both, full), key


def test_pool_replication_fallback_when_heads_do_not_divide(fallback):
    ref, ranks = fallback
    K = tconfigs.get_reduced("internlm2-1.8b").n_kv_heads
    for r in ranks:
        assert r["model_shards"] == 4 and not r["plan"]["attn"]
        assert r["tokens"] == ref
        assert all(shape[-2] == K for shape in r["pools"].values())
        total, per_dev = r["pool_bytes"]
        assert total == per_dev == r["paged_pool_bytes"]


@pytest.mark.parametrize("arch", MOE)
def test_ep_moe_decodes_under_scheduler(served, arch):
    jobs, extra = served
    ref, ranks = jobs[f"ep/{arch}"]
    assert not extra[f"ep/{arch}"]  # off a mesh: the capacity dispatch, with its reason
    assert "no mesh" in extra[f"ep/{arch}"].reason
    for r in ranks:
        assert r["ep_moe"] and r["plan"]["ep"]
        assert r["tokens"] == ref


def test_model_axis_refused_for_families_without_tp_form(served):
    """mamba2 on a (1, 2) mesh: no tensor-parallel form yet, the engine
    names the ROADMAP item (a data axis alone would serve)."""
    jobs, _ = served
    for r in jobs["refuse/mamba2"][1]:
        assert "ROADMAP Queue 1 item 5" in r["refused"] and "'ssm'" in r["refused"]


def test_engine_pins_ambient_mesh_at_construction():
    cfg = tconfigs.get_reduced("internlm2-1.8b")
    mesh = Mesh((1, 1), ("data", "model"))
    with mesh:
        assert current_mesh() is mesh
        eng = ServeEngine(cfg, init_lm(0, cfg, device="cpu"), max_len=MAX_LEN,
                          compute_dtype=torch.float32, device="cpu")
    assert current_mesh() is None
    assert eng.mesh is mesh and eng.model_shards() == 1 and eng.rules is not None
    assert eng.cfg == cfg  # a 1-rank mesh serves exactly as no mesh
