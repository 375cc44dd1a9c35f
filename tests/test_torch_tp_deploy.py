"""Port parity of the tensor-parallel deploy layout and its checks
(``awq_tpu_torch/parallel``): a rank's shard built by the port's
``build_tp_params`` against the JAX package's ``build_tp_params`` shard
of that rank (``convert.rank_tree_from_jax``), bit for bit;
``check_tp_compatible``, ``pick_mesh_shape`` and ``parse_mesh_arg``
against JAX's; tp = 1 against the single-device layout; the cache shard;
the groups of a ``dp > 1`` layout over four spawned gloo ranks.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig
from awq_tpu_torch.config import QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax, rank_tree_from_jax, unfold_qlinear
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops.w4a16 import QLinear
from awq_tpu_torch.parallel import mesh as tmesh
from awq_tpu_torch.parallel.deploy import build_tp_params as tbuild
from awq_tpu_torch.parallel.mesh import TPGroup
from awq_tpu_torch.parallel.shard import shard_cache
from awq_tpu_torch.parallel.tp import check_tp_compatible as tcheck

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=256, dtype="float32")


def _group(rank, tp):
    return TPGroup(rank=rank, size=tp, group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("w_bit", [4, 3])
def test_rank_shards_equal_jax_deploy_bit_for_bit(w_bit):
    """Each rank's codes, scales and szeros of the four fused linears and
    the quantized head, its embedding, norms and q/k/v bias, from the
    port's ``build_tp_params``, equal the JAX package's shard of that rank
    (tp = 2, ``quantize_head=True``) bit for bit: the codes unfolded from
    the folded tiles, the scales and szeros the f32 fields the shard keeps
    beside them."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig, QuantConfig
    from awq_tpu.models.llama import init_params, quantize_params
    from awq_tpu.parallel import MeshConfig, build_tp_params, make_mesh

    cfg = ModelConfig(**dict(GEOM, arch="qwen2", qkv_bias=True))
    plain = quantize_params(init_params(cfg, jax.random.PRNGKey(2), scale=0.05),
                            QuantConfig(w_bit=w_bit, group_size=128))
    rng = np.random.default_rng(0)
    la = dict(plain["layers"])
    for n in ("wq", "wk", "wv"):
        la[n] = dataclasses.replace(la[n], bias=jnp.asarray(
            rng.standard_normal(la[n].bias.shape).astype(np.float32)))
    plain = dict(plain, layers=la)
    dep = build_tp_params(plain, cfg, make_mesh(MeshConfig(dp=1, tp=2),
                                                devices=jax.devices()[:2]), quantize_head=True)
    host = types.SimpleNamespace(params=jax.device_get(dep.params), pspecs=dep.pspecs, tp=2)
    tplain = params_from_jax(jax.device_get(plain), device="cpu")
    tcfg = TConfig(**dict(GEOM, arch="qwen2", qkv_bias=True))
    for rank in range(2):
        jr = rank_tree_from_jax(host, rank)
        tr = tbuild(tplain, tcfg, _group(rank, 2), quantize_head=True)
        assert sorted(tr["layers"]) == sorted(jr["layers"])
        pairs = [(tr["layers"][n], jr["layers"][n]) for n in ("wqkv", "wo", "wgateup", "down")]
        pairs.append((tr["lm_head"], jr["lm_head"]))
        for t, j in pairs:
            assert isinstance(t, QLinear) and t.dense3 == bool(j.dense3)
            codes = unfold_qlinear(j)[0]
            if t.qweight.dim() == 2:                           # the head, stacked-of-1 in JAX
                codes, js, jz = codes[0], np.asarray(j.scales)[0], np.asarray(j.szeros)[0]
            else:
                js, jz = np.asarray(j.scales), np.asarray(j.szeros)
            np.testing.assert_array_equal(t.qweight.numpy(), codes)
            np.testing.assert_array_equal(t.scales.numpy().view(np.uint32), js.view(np.uint32))
            np.testing.assert_array_equal(t.szeros.numpy().view(np.uint32), jz.view(np.uint32))
        np.testing.assert_array_equal(tr["layers"]["wqkv"].bias.numpy(),
                                      np.asarray(jr["layers"]["wqkv"].bias))
        for n in ("ln1", "ln2"):
            np.testing.assert_array_equal(tr["layers"][n].numpy(), np.asarray(jr["layers"][n]))
        for n in ("embed", "norm"):
            np.testing.assert_array_equal(tr[n].numpy(), np.asarray(jr[n]))
        assert tr["embed"].shape[0] == GEOM["vocab_size"] // 2


def _fake_plain(jcfg, w_bit=4, dense3=False, fused=False, act_scale=False):
    """A plain (unfused) JAX tree of zero-filled QLinears of ``jcfg``'s shapes."""
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import QLinear as JQLinear

    L, H, I = jcfg.num_layers, jcfg.hidden_size, jcfg.intermediate_size
    hd = jcfg.head_dim

    def ql(ic, oc):
        rows = ic * 3 // 32 if dense3 else ic // 8
        z = jnp.zeros((L, ic // 128, oc), jnp.float32)
        return JQLinear(qweight=jnp.zeros((L, rows, oc), jnp.int32), scales=z, szeros=z,
                        w_bit=w_bit, group_size=128, dense3=dense3)

    nq, nkv = jcfg.num_heads, jcfg.num_kv_heads
    layers = {"ln1": jnp.ones((L, H)), "ln2": jnp.ones((L, H)),
              "wq": ql(H, nq * hd), "wk": ql(H, nkv * hd), "wv": ql(H, nkv * hd),
              "wo": ql(nq * hd, H), "gate": ql(H, I), "up": ql(H, I), "down": ql(I, H)}
    if fused:
        layers["wqkv"] = layers.pop("wq")
    if act_scale:
        layers["act_scale"] = jnp.ones((L, H))
    return {"embed": jnp.zeros((jcfg.vocab_size, H)), "layers": layers,
            "norm": jnp.ones((H,))}


@pytest.mark.parametrize("geom,tp,kw", [
    ({}, 1, {}),
    ({}, 2, {}),
    ({}, 3, {}),                                                   # heads
    (dict(num_kv_heads=1), 2, {}),                                 # kv heads
    (dict(vocab_size=510), 2, {}),                                 # vocabulary
    ({}, 2, dict(fused=True)),                                     # fused input
    ({}, 2, dict(act_scale=True)),
    (dict(num_heads=8, num_kv_heads=8, head_dim=64), 8, {}),       # wo's 4 groups
    (dict(num_kv_heads=4), 4, dict(w_bit=3, dense3=True)),         # 128-channel W3 shards
    (dict(num_kv_heads=4, hidden_size=1024, num_heads=8, intermediate_size=2048), 4,
     dict(w_bit=3, dense3=True)),                                  # 256: taken
], ids=["tp1", "tp2", "heads", "kv_heads", "vocab", "fused", "act_scale", "groups",
        "dense3_chunk", "dense3_ok"])
def test_check_tp_compatible_raises_where_jax_does(geom, tp, kw):
    """The port's check raises where JAX's does, with JAX's message; both
    pass on the same inputs otherwise."""
    from awq_tpu.config import ModelConfig
    from awq_tpu.parallel.tp import check_tp_compatible as jcheck

    jcfg = ModelConfig(**dict(GEOM, **geom))
    jp = _fake_plain(jcfg, **kw)
    tp_params = params_from_jax(_host(jp), device="cpu")
    try:
        jcheck(jp, jcfg, tp)
        jerr = None
    except ValueError as e:
        jerr = str(e)
    if jerr is None:
        tcheck(tp_params, TConfig(**dict(GEOM, **geom)), tp)
    else:
        with pytest.raises(ValueError) as e:
            tcheck(tp_params, TConfig(**dict(GEOM, **geom)), tp)
        assert str(e.value) == jerr


def _host(tree):
    import jax

    return jax.device_get(tree)


def test_tp1_is_the_single_device_layout():
    """At tp = 1 the deploy layout is the single-device engine's: the fused
    tree of ``fuse_linears`` (after ``quantize_head``), tensor for tensor."""
    cfg = TConfig(**GEOM)
    params = tllama.init_qparams(cfg, TQuant(4, 128),
                                 torch.Generator().manual_seed(1), device="cpu")
    got = tbuild(params, cfg, _group(0, 1), quantize_head=True)
    ref = tllama.fuse_linears(tllama.quantize_head(params, cfg), cfg)
    assert sorted(got) == sorted(ref) and sorted(got["layers"]) == sorted(ref["layers"])
    for k in ref["layers"]:
        a, b = got["layers"][k], ref["layers"][k]
        if isinstance(b, QLinear):
            for f in ("qweight", "scales", "szeros"):
                assert torch.equal(getattr(a, f), getattr(b, f)), k
        else:
            assert torch.equal(a, b), k
    assert torch.equal(got["embed"], ref["embed"])
    assert torch.equal(got["lm_head"].qweight, ref["lm_head"].qweight)


def test_quantize_head_skipped_where_jax_skips_it():
    """``quantize_head`` at a vocabulary whose per-rank slice is not a
    multiple of 128 keeps the head fp (and vocab-sharded), as JAX's
    ``build_tp_params`` decides (Llama-3's 128256 at tp = 4)."""
    cfg = TConfig(**dict(GEOM, vocab_size=768))            # 384 per rank at tp = 2: taken
    params = tllama.init_qparams(cfg, TQuant(4, 128),
                                 torch.Generator().manual_seed(1), device="cpu")
    assert isinstance(tbuild(params, cfg, _group(1, 2), quantize_head=True)["lm_head"], QLinear)
    cfg = TConfig(**dict(GEOM, vocab_size=640))            # 320 per rank
    params["lm_head"] = torch.zeros((512, 640))
    params["embed"] = torch.zeros((640, 512))
    with pytest.warns(UserWarning, match="quantize_head skipped"):
        head = tbuild(params, cfg, _group(1, 2), quantize_head=True)["lm_head"]
    assert isinstance(head, torch.Tensor) and tuple(head.shape) == (512, 320)
    with pytest.raises(NotImplementedError, match="item 17b"):
        tbuild(params, cfg, _group(0, 2), prefill_w8=True)


@pytest.mark.parametrize("n_params_b", [0.5, 7, 13, 34, 70, 180])
@pytest.mark.parametrize("n_devices,max_tp", [(1, 8), (2, 8), (4, 8), (6, 8), (8, 8), (8, 2)])
def test_pick_mesh_shape_equals_jax(n_params_b, n_devices, max_tp):
    from awq_tpu.parallel.mesh import pick_mesh_shape as jpick

    j = jpick(n_params_b, n_devices=n_devices, max_tp=max_tp)
    t = tmesh.pick_mesh_shape(n_params_b, n_devices=n_devices, max_tp=max_tp)
    assert (t.dp, t.tp) == (j.dp, j.tp)


@pytest.mark.parametrize("arg", ["", None, "2", "4", "1,2", "2,2", "2,4", "8"])
def test_parse_mesh_arg_equals_jax(arg):
    """The shape the port parses equals the JAX mesh's axes (the port
    returns the shape; ``make_mesh`` turns it into this process's group)."""
    from awq_tpu.parallel.mesh import parse_mesh_arg as jparse

    j, t = jparse(arg), tmesh.parse_mesh_arg(arg)
    if j is None:
        assert t is None
        return
    shape = dict(zip(j.axis_names, j.devices.shape))
    assert (t.dp, t.tp) == (shape["dp"], shape["tp"])


def test_rank_shard_holds_only_its_own_bytes():
    """Every tensor of a rank's deploy shard owns exactly its own storage:
    no slice (the embedding's vocab rows, say) is a view that keeps the
    whole model's tensor alive on the device the shard goes to."""
    cfg = TConfig(**GEOM)
    plain = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=128),
                                torch.Generator().manual_seed(0), device="cpu")
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, QLinear):
            leaves.extend(t for t in (x.qweight, x.scales, x.szeros, x.bias) if t is not None)
        elif isinstance(x, torch.Tensor):
            leaves.append(x)

    walk(tbuild(plain, cfg, _group(1, 2), quantize_head=True))
    assert leaves
    for t in leaves:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), t.shape


def test_shard_cache_takes_the_rank_kv_heads():
    """A rank's cache is its kv heads (axis 3), codes and scales alike, as
    JAX's ``cache_specs`` places them; a cache whose heads do not split
    stays whole."""
    cache = torch.arange(2 * 2 * 1 * 4 * 8 * 2, dtype=torch.float32).reshape(2, 2, 1, 4, 8, 2)
    for r in range(2):
        assert torch.equal(shard_cache(cache, r, 2), cache[:, :, :, 2 * r:2 * r + 2])
    c8 = tllama.KVCache8(cache.to(torch.int8), cache[..., 0])
    s = shard_cache(c8, 1, 4)
    assert torch.equal(s.data, c8.data[:, :, :, 1:2]) and torch.equal(s.scales, c8.scales[:, :, :, 1:2])
    assert shard_cache(cache, 1, 3) is cache


def _mesh_rank(rank, store_path, out_path):
    """One of four gloo ranks on the CPU: its group in a dp = 2, tp = 2
    layout from ``make_mesh`` and from ``make_multihost_mesh`` (``tp`` given,
    and from ``LOCAL_WORLD_SIZE``), an all-reduce and a broadcast in each;
    then the default device without a card. Writes its results."""
    import torch.distributed as dist

    from awq_tpu_torch.parallel.distributed import init_distributed, make_multihost_mesh

    torch.set_num_threads(1)
    init_distributed("gloo", rank=rank, world_size=4, timeout_s=60,
                     store=dist.FileStore(store_path, 4), device="cpu")
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    out = {}
    for name, build in (("make_mesh", lambda: tmesh.make_mesh(tmesh.MeshConfig(dp=2, tp=2),
                                                              device="cpu")),
                        ("multihost", lambda: make_multihost_mesh(tp=2, device="cpu")),
                        ("local_world", lambda: make_multihost_mesh(device="cpu"))):
        g = build()
        s, b = torch.tensor([float(rank)]), torch.tensor([10.0 * rank])
        g.all_reduce(s)
        g.broadcast(b)
        out[name] = (g.rank, g.size, g.dp, str(g.device), s.item(), b.item())
    torch.cuda.is_available = lambda: False        # a host without a card
    try:
        tmesh.make_mesh(tmesh.MeshConfig(dp=2, tp=2))
    except RuntimeError as e:
        out["no_card"] = str(e)
    torch.save(out, out_path)
    dist.destroy_process_group()


def test_dp_layout_groups_over_four_gloo_ranks(tmp_path):
    """Four spawned gloo ranks on the CPU in a dp = 2, tp = 2 layout: global
    rank r is rank r % 2 of group r // 2 (tp the fastest axis, as in the
    JAX mesh), whether ``make_mesh`` or ``make_multihost_mesh`` builds it;
    a group's all-reduce sums its own ranks only and its broadcast comes
    from its own rank 0; and without a card the default device raises
    instead of falling back to the CPU."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, str(tmp_path / "store"),
                                                  str(tmp_path / f"rank{r}.pt")))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"ranks {hung} did not finish within 120 s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        group = r // 2
        want = (r % 2, 2, 2, "cpu", float(4 * group + 1), 20.0 * group)
        assert got["make_mesh"] == got["multihost"] == got["local_world"] == want, got
        assert "torch.cuda.is_available() is False" in got["no_card"]


def test_init_distributed_takes_the_cpu_only_when_asked(monkeypatch):
    """Without a card, a gloo rank that does not ask for the CPU raises
    before it joins the group; NCCL refuses the CPU; nothing initializes."""
    import torch.distributed as dist

    from awq_tpu_torch.parallel.distributed import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = dist.HashStore()
    with pytest.raises(RuntimeError, match="is_available"):
        init_distributed("gloo", rank=0, world_size=1, store=store)
    with pytest.raises(ValueError, match="backend='gloo'"):
        init_distributed("nccl", rank=0, world_size=1, store=store, device="cpu")
    with pytest.raises(ValueError, match="only 'cpu'"):
        init_distributed("gloo", rank=0, world_size=1, store=store, device="cuda:0")
    with pytest.raises(ValueError, match="backend must be"):
        init_distributed("mpi", rank=0, world_size=1, store=store, device="cpu")
    assert not dist.is_initialized()
