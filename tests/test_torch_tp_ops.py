"""The port's tensor- and expert-parallel ops against the JAX package's, on
the CPU (the JAX side on the conftest's 8-device CPU mesh, the port's ranks
on a list of CPU devices):

- `paged_attention_tp` (MHA and GQA over a mixed prefill/decode batch, with
  and without an int8 KV scale; the indivisible-heads case, which the port
  runs as the replicated-K/V form and JAX as its partitioned oracle; the MLA
  latent plane, replicated on every rank) against the JAX
  `paged_attention_tp` (tests/parallel/test_tp_attention.py);
- `moe_ffn_ep` against the JAX `moe_ffn_ep`, and one MoE decoder step under
  EP against the JAX single-device step (tests/ops/test_moe.py:70, :92);
- the shard rules: each rank's qkv and gate_up columns, a QuantizedTensor's
  scales in lockstep (int8, int4, fp8), the ranks reassembling the
  single-device product; the refusals (int4 at K 11008 over 4 ranks, a
  vocabulary of 92553 over 2, q heads), beside what the JAX
  shard_decoder_weights does with the same shapes;
- the node's check that keeps decode graphs to ranks on one card.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from hydrainfer_tpu.models.decoder import decoder_forward as jax_decoder_forward
from hydrainfer_tpu.models.decoder import init_rope_tables as jax_rope_tables
from hydrainfer_tpu.models.decoder import pack_decoder_weights
from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxParams
from hydrainfer_tpu.ops.attention import paged_attention_tp as jax_paged_attention_tp
from hydrainfer_tpu.ops.moe import moe_ffn_ep as jax_moe_ffn_ep
from hydrainfer_tpu.ops.moe import topk_softmax as jax_topk_softmax
from hydrainfer_tpu.ops.quant import quantize_int4 as jax_quantize_int4
from hydrainfer_tpu.parallel.mesh import make_mesh
from hydrainfer_tpu.parallel.mesh import shard_decoder_weights as jax_shard_decoder_weights
from hydrainfer_tpu.parallel.mesh import shard_kv_cache as jax_shard_kv_cache
from hydrainfer_tpu_torch.cluster.node import check_graph_devices
from hydrainfer_tpu_torch.models.decoder import DecoderConfig, decoder_forward, init_rope_tables
from hydrainfer_tpu_torch.models.factory import LanguageModelBatch
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams, paged_attention_tp
from hydrainfer_tpu_torch.ops.moe import moe_ffn_ep, topk_softmax
from hydrainfer_tpu_torch.ops.quant import (dequantize, qmatmul, quantize_fp8,
                                            quantize_int4, quantize_int8)
from hydrainfer_tpu_torch.parallel.mesh import (RankGroup, merge_kv_shards,
                                                shard_decoder_weights, shard_kv_cache,
                                                tp_layout)

CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=2e-5)


def cpus(tp: int) -> RankGroup:
    """tp ranks, all on the CPU."""
    return RankGroup((CPU,) * tp)


def jax_mesh(tp: int):
    return make_mesh(tp, axis_names=("dp", "tp"), shape=(1, tp))


def heads_cfg(hq: int, hkv: int, latent: bool = False):
    return SimpleNamespace(n_qo_heads=hq, n_kv_heads=hkv, mla_kv_lora=8 if latent else 0)


def build_batch(rng, kvh=4, h=8, d=16, planes=None, n_blocks=16, block_size=4):
    """The JAX test's batch: two prefill chunks and two decode steps over one
    paged cache of 2 layers (planes = 2 * kvh, or 1 for a latent cache).
    Returns (q, cache, JAX params, port params) as numpy / both packages'."""
    planes = 2 * kvh if planes is None else planes
    cache = rng.standard_normal((2, 1, n_blocks, block_size, planes, d)).astype(np.float32)
    q_lens, kv_lens = [5, 3, 1, 1], [5, 5, 7, 9]
    positions = [0, 1, 2, 3, 4, 2, 3, 4, 6, 8]
    T = sum(q_lens)
    q = rng.standard_normal((T, h, d)).astype(np.float32)
    tables = np.full((4, 3), -1, np.int32)
    b = 1
    for s, kl in enumerate(kv_lens):
        for j in range(-(-kl // block_size)):
            tables[s, j] = b
            b += 1
    fields = dict(
        q_seq_ids=np.asarray(sum(([i] * n for i, n in enumerate(q_lens)), []), np.int32),
        q_local_ids=np.asarray(sum((list(range(n)) for n in q_lens), []), np.int32),
        positions=np.asarray(positions, np.int32),
        kv_lens=np.asarray(kv_lens, np.int32), block_tables=tables,
        new_kv_slot_ids=np.full((T,), -1, np.int32),
        cu_q_lens=np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32),
        num_seqs=np.asarray([4], np.int32))
    return (q, cache, JaxParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            PagedAttentionParams(**{k: torch.from_numpy(v) for k, v in fields.items()}))


def port_tp_attention(q, cache, params, layer, tp, cfg, kv_scale=None, max_q=5):
    """The ranks' outputs, each over its q heads and cache shard, gathered
    along the head axis as the JAX function returns them."""
    layout = tp_layout(cfg, tp)
    shards = [(CPU, *layout.cache_heads(r)) for r in range(tp)]
    caches = shard_kv_cache(torch.from_numpy(cache), shards)
    qs = torch.from_numpy(q).split(layout.q_heads, dim=1)
    outs = paged_attention_tp(qs, caches, layer, [params] * tp, 0.25, max_q,
                              kv_scale=kv_scale)
    return cpus(tp).gather(outs, dim=1).numpy()


@pytest.mark.parametrize("tp", [4, 8])
@pytest.mark.parametrize("kv_scale", [None, 0.05], ids=["f32_kv", "int8_kv"])
def test_paged_attention_tp_matches_jax(kv_scale, tp):
    """8 q over 4 KV heads: at tp 4 each rank holds one KV pair; at tp 8
    each pair is held by two ranks (the replicated-K/V form), where JAX
    replicates the cache and takes its partitioned oracle."""
    q, cache, jparams, params = build_batch(np.random.default_rng(0))
    if kv_scale is not None:
        cache = np.clip(np.round(cache / kv_scale), -127, 127).astype(np.int8)
    mesh = jax_mesh(tp)
    q_s = jax.device_put(jnp.asarray(q), jax.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "tp", None)))
    ref = jax.jit(lambda *a: jax_paged_attention_tp(
        *a, sm_scale=0.25, max_q=5, mesh=mesh, kv_scale=kv_scale))(
            q_s, jax_shard_kv_cache(jnp.asarray(cache), mesh), 1, jparams)
    got = port_tp_attention(q, cache, params, 1, tp, heads_cfg(8, 4), kv_scale)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_paged_attention_tp_indivisible_kv_heads():
    """6 q over 3 KV heads at tp 6: JAX falls back to its partitioned
    oracle, the port gives each rank a copy of its q head's KV head (the
    same function). tp 4 and 8 do not divide the q heads: refused."""
    q, cache, jparams, params = build_batch(np.random.default_rng(1), kvh=3, h=6)
    ref = jax.jit(lambda *a: jax_paged_attention_tp(*a, 0, jparams, 0.25, max_q=5,
                                                    mesh=jax_mesh(6)))(
        jnp.asarray(q), jnp.asarray(cache))
    layout = tp_layout(heads_cfg(6, 3), 6)
    assert layout.kv_heads == 1 and layout.kv_first == (0, 0, 1, 1, 2, 2)
    got = port_tp_attention(q, cache, params, 0, 6, heads_cfg(6, 3))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    for tp in (4, 8):
        with pytest.raises(NotImplementedError, match="does not divide the 6 q heads"):
            tp_layout(heads_cfg(6, 3), tp)


def test_paged_attention_tp_latent_plane():
    """MLA: one int8 latent plane serves as K and V; 8 q heads split over 4
    ranks, each over a full copy of the plane (JAX: shard_map with the
    cache replicated, each shard on its jnp oracle)."""
    q, cache, jparams, params = build_batch(np.random.default_rng(2), h=8, d=24, planes=1)
    kv_scale = 0.05
    cache = np.clip(np.round(cache / kv_scale), -127, 127).astype(np.int8)
    mesh = jax_mesh(4)
    ref = jax.jit(lambda *a: jax_paged_attention_tp(
        *a, 1, jparams, 0.25, max_q=5, mesh=mesh, impl="jnp", kv_scale=kv_scale))(
            jnp.asarray(q), jnp.asarray(cache))
    got = port_tp_attention(q, cache, params, 1, 4, heads_cfg(8, 1, latent=True), kv_scale)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("cfg,tp", [(heads_cfg(8, 4), 2), (heads_cfg(4, 2), 4),
                                    (heads_cfg(8, 1, latent=True), 2)],
                         ids=["kv_split", "kv_copies", "latent"])
def test_kv_cache_shards_round_trip(cfg, tp):
    """shard_kv_cache then merge_kv_shards gives the single-device cache
    back, whichever rank holds a head first."""
    layout = tp_layout(cfg, tp)
    shards = [(CPU, *layout.cache_heads(r)) for r in range(tp)]
    planes = 1 if layout.single_plane else 2 * cfg.n_kv_heads
    cache = torch.randn(2, 1, 3, 4, planes, 8)
    parts = shard_kv_cache(cache, shards)
    assert all(p.is_contiguous() and p.data_ptr() != cache.data_ptr() for p in parts)
    assert torch.equal(merge_kv_shards(parts, shards), cache)


def test_moe_ffn_ep_matches_jax():
    """16 experts over 8 ranks, tokens and routing replicated."""
    rng = np.random.default_rng(7)
    T, E, k, d, inter = 24, 16, 2, 16, 32
    x = rng.standard_normal((T, d)).astype(np.float32)
    gate_up = (rng.standard_normal((E, d, 2 * inter)) * 0.1).astype(np.float32)
    down = (rng.standard_normal((E, inter, d)) * 0.1).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    w, idx = jax_topk_softmax(jnp.asarray(logits), k)
    mesh = jax_mesh(8)
    ref = jax.jit(lambda *a: jax_moe_ffn_ep(*a, mesh=mesh, axis="tp"))(
        jnp.asarray(x), jnp.asarray(gate_up), jnp.asarray(down), w, idx)
    pw, pidx = topk_softmax(torch.from_numpy(logits), k)
    gu, dn = torch.from_numpy(gate_up), torch.from_numpy(down)
    got = moe_ffn_ep(torch.from_numpy(x), list(gu.split(2)), list(dn.split(2)), pw, pidx,
                     cpus(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    # each rank's extra partial (a layer's shared experts) joins the one sum
    extra = [torch.full((T, d), float(r)) for r in range(8)]
    with_extra = moe_ffn_ep(torch.from_numpy(x), list(gu.split(2)), list(dn.split(2)), pw,
                            pidx, cpus(8), extra=extra)
    np.testing.assert_allclose(with_extra.numpy(), np.asarray(ref) + 28.0, rtol=2e-4,
                               atol=2e-4)


def test_moe_decoder_step_under_ep_matches_jax():
    """One MoE decoder step (2 layers of 16 routed experts, 8 heads) over 8
    ranks: the port's tokens and logits against the JAX single-device
    step's (tests/ops/test_moe.py:92 holds the JAX TP step to the same)."""
    kw = dict(n_layers=2, hidden_size=64, intermediate_size=64, n_qo_heads=8,
              n_kv_heads=8, head_dim=8, vocab_size=128, max_position_embeddings=64,
              moe_top_k=2, n_experts=16)
    jcfg, cfg = JaxDecoderConfig(**kw), DecoderConfig(**kw)
    raw = init_decoder_weights(jcfg, jax.random.PRNGKey(0), jnp.float32)
    rngw = np.random.default_rng(11)
    for lw in raw["layers"]:
        del lw["gate_up"], lw["down"]
        lw["moe_router"] = jnp.asarray(rngw.standard_normal((64, 16)).astype(np.float32) * 0.1)
        lw["moe_gate_up"] = jnp.asarray(
            rngw.standard_normal((16, 64, 64)).astype(np.float32) * 0.1)
        lw["moe_down"] = jnp.asarray(
            rngw.standard_normal((16, 32, 64)).astype(np.float32) * 0.1)
    np_tree = jax.tree_util.tree_map(np.asarray, raw)
    weights = from_jax_numpy(np_tree, "cpu")
    S, T, bs, nb = 2, 8, 4, 32
    q_seq = np.array([0] * 6 + [1] * 2, np.int32)
    pos = np.array([0, 1, 2, 3, 4, 5, 0, 1], np.int32)
    tables = np.full((S, 4), -1, np.int32)
    tables[0, :2], tables[1, :1] = [0, 1], [2]
    fields = dict(q_seq_ids=q_seq, q_local_ids=pos.copy(), positions=pos,
                  kv_lens=np.array([6, 2], np.int32), block_tables=tables,
                  new_kv_slot_ids=(tables[q_seq, pos // bs] * bs + pos % bs).astype(np.int32),
                  cu_q_lens=np.array([0, 6, 8], np.int32), num_seqs=np.array([S], np.int32))
    top = dict(token_ids=np.arange(T, dtype=np.int32) + 3, positions=pos,
               sample_token_idx=np.array([5, 7], np.int32),
               token_src_slots=np.full((T,), -1, np.int32),
               sample_dst_slots=np.full((S,), -1, np.int32))
    jbatch = JaxBatch(attention=JaxParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
                      image_features=jnp.zeros((0, 64), jnp.float32),
                      image_dst_idx=jnp.zeros((0,), jnp.int32),
                      **{k: jnp.asarray(v) for k, v in top.items()})
    cos, sin = jax_rope_tables(jcfg)
    jcache = jnp.zeros((2, 1, nb, bs, 16, 8), jnp.float32)
    _, _, jtok, jlogits = jax.jit(lambda *a: jax_decoder_forward(
        *a, jcfg, max_q=8, return_logits=True))(pack_decoder_weights(raw), jcache, jbatch,
                                                cos, sin)
    batch = LanguageModelBatch(
        attention=PagedAttentionParams(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        **{k: torch.from_numpy(v) for k, v in top.items()})
    sharded = shard_decoder_weights(weights, cfg, cpus(8))
    assert [w["layers"][0]["moe_gate_up"].shape[0] for w in sharded.ranks] == [2] * 8
    shards = sharded.cache_shards()
    caches = shard_kv_cache(torch.zeros(2, 1, nb, bs, 16, 8), shards)
    ctab, stab = init_rope_tables(cfg)
    tok, logits = decoder_forward(sharded, caches, batch, ctab, stab, cfg, 8,
                                  torch.zeros(1, dtype=torch.int32), return_logits=True)
    assert tok.tolist() == np.asarray(jtok).tolist()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ shard rules

HID, HEAD_DIM = 128, 16


def _weights(quant: str):
    """A one-layer GQA decoder (hidden 128, 8 q / 4 KV heads of 16, MLP 128)
    with its matmul weights in `quant` (int4 at g = 32, so 4 ranks still
    get whole groups; fp8 with (16-row group, column) scales)."""
    cfg = DecoderConfig(n_layers=1, hidden_size=HID, intermediate_size=HID, n_qo_heads=8,
                        n_kv_heads=4, head_dim=HEAD_DIM, vocab_size=64,
                        max_position_embeddings=16)
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    quantize = {"none": lambda w: w, "int8": quantize_int8,
                "int4": lambda w: quantize_int4(w, 32), "fp8": lambda w: quantize_fp8(w, 16)}[quant]
    lw = {"qkv_proj": quantize(rnd(HID, 2 * HID)), "o_proj": quantize(rnd(HID, HID)),
          "gate_up": quantize(rnd(HID, 2 * HID)), "down": quantize(rnd(HID, HID)),
          "qkv_bias": rnd(2 * HID), "input_norm": rnd(HID), "post_norm": rnd(HID)}
    return cfg, {"embed": rnd(64, HID), "norm": rnd(HID), "lm_head": rnd(HID, 64),
                 "layers": [lw]}


def _dense(w):
    return dequantize(w, torch.float32) if hasattr(w, "q") else w


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", ["none", "int8", "int4", "fp8"])
def test_shard_rules_reassemble_the_single_device_layer(quant, tp):
    """Every rank's qkv columns are [q_r | k_r | v_r] and its gate_up
    columns [gate_r | up_r], with a quantized weight's scales taken in
    lockstep (per column, or int4's and fp8's (group, column) tables split
    with their rows), so each rank's dequantized weight is the single-device
    one's slice exactly; the column products reassemble and the row-parallel
    partials sum to the single-device product."""
    cfg, w = _weights(quant)
    sharded = shard_decoder_weights(w, cfg, cpus(tp))
    lw, D, hq, hkv = w["layers"][0], HEAD_DIM, 8, 4
    q_cols, kv_cols = hq * D // tp, hkv * D // tp
    x = torch.randn(5, HID, generator=torch.Generator().manual_seed(1))
    full_qkv = qmatmul(x, lw["qkv_proj"])
    full_gu = qmatmul(x, lw["gate_up"])
    parts = {"q": [], "k": [], "v": [], "gate": [], "up": [], "o": [], "down": []}
    for r, rank in enumerate(sharded.ranks):
        rl = rank["layers"][0]
        cols = torch.cat([torch.arange(r * q_cols, (r + 1) * q_cols),
                          hq * D + torch.arange(r * kv_cols, (r + 1) * kv_cols),
                          (hq + hkv) * D + torch.arange(r * kv_cols, (r + 1) * kv_cols)])
        assert torch.equal(_dense(rl["qkv_proj"]), _dense(lw["qkv_proj"])[:, cols])
        assert torch.equal(rl["qkv_bias"], lw["qkv_bias"][cols])
        gu_cols = torch.cat([torch.arange(r * HID // tp, (r + 1) * HID // tp),
                             HID + torch.arange(r * HID // tp, (r + 1) * HID // tp)])
        assert torch.equal(_dense(rl["gate_up"]), _dense(lw["gate_up"])[:, gu_cols])
        rows = slice(r * HID // tp, (r + 1) * HID // tp)
        assert torch.equal(_dense(rl["o_proj"]), _dense(lw["o_proj"])[rows])
        assert torch.equal(_dense(rl["down"]), _dense(lw["down"])[rows])
        assert torch.equal(rank["embed"], w["embed"][r * 64 // tp:(r + 1) * 64 // tp])
        assert torch.equal(rank["lm_head"], w["lm_head"][:, r * 64 // tp:(r + 1) * 64 // tp])
        assert rank["norm"] is w["norm"] and rl["input_norm"] is lw["input_norm"]
        q, k, v = qmatmul(x, rl["qkv_proj"]).split([q_cols, kv_cols, kv_cols], dim=-1)
        gate, up = qmatmul(x, rl["gate_up"]).chunk(2, dim=-1)
        for name, t in (("q", q), ("k", k), ("v", v), ("gate", gate), ("up", up)):
            parts[name].append(t)
        parts["o"].append(qmatmul(x[:, rows], rl["o_proj"]))
        parts["down"].append(qmatmul(x[:, rows], rl["down"]))
    tol = dict(rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(torch.cat(parts["q"] + parts["k"] + parts["v"], -1),
                               full_qkv, **tol)
    torch.testing.assert_close(torch.cat(parts["gate"] + parts["up"], -1), full_gu, **tol)
    torch.testing.assert_close(cpus(tp).all_reduce(parts["o"]),
                               qmatmul(x, lw["o_proj"]), **tol)
    torch.testing.assert_close(cpus(tp).all_reduce(parts["down"]),
                               qmatmul(x, lw["down"]), **tol)


def test_int4_rows_that_split_a_group_are_refused():
    """llava-7b-lm's down (K 11008) at int4, g = 128: 5504 rows a rank at tp
    2 (43 groups), 2752 at tp 4 (21.5 groups), which the port refuses by
    name and shape. The JAX shard_decoder_weights raises too: device_put
    cannot split the (86, N) scale table over 4 devices."""
    w = torch.randn(11008, 8, generator=torch.Generator().manual_seed(0))
    qt = quantize_int4(w)
    assert qt.group == 128 and tuple(qt.q.shape) == (5504, 8)
    cfg = DecoderConfig(n_layers=1, hidden_size=8, intermediate_size=11008, n_qo_heads=4,
                        n_kv_heads=4, head_dim=2, vocab_size=16,
                        max_position_embeddings=8)
    tree = {"embed": torch.zeros(16, 8), "norm": torch.ones(8),
            "lm_head": torch.zeros(8, 16), "layers": [{"down": qt}]}
    two = shard_decoder_weights(tree, cfg, cpus(2))
    for r, rank in enumerate(two.ranks):
        assert torch.equal(dequantize(rank["layers"][0]["down"], torch.float32),
                           dequantize(qt, torch.float32)[r * 5504:(r + 1) * 5504])
    with pytest.raises(NotImplementedError, match=r"down: .*input dim 11008.*group 128"):
        shard_decoder_weights(tree, cfg, cpus(4))
    jtree = {"embed": jnp.zeros((16, 8)), "norm": jnp.ones(8), "lm_head": jnp.zeros((8, 16)),
             "layers": [{"down": jax_quantize_int4(jnp.asarray(w.numpy()))}]}
    with pytest.raises(ValueError, match="divisible by 4"):
        jax_shard_decoder_weights(jtree, jax_mesh(4))


def test_vocabulary_the_tp_size_does_not_divide_is_refused():
    """InternLM2's 92553-token vocabulary over 2 ranks: the port refuses it
    at load, naming the size; JAX's device_put raises as well."""
    cfg = DecoderConfig(n_layers=0, hidden_size=4, intermediate_size=8, n_qo_heads=2,
                        n_kv_heads=2, head_dim=2, vocab_size=92553,
                        max_position_embeddings=8)
    tree = {"embed": torch.zeros(92553, 4), "norm": torch.ones(4),
            "lm_head": torch.zeros(4, 92553), "layers": []}
    with pytest.raises(NotImplementedError, match=r"vocabulary \(92553\)"):
        shard_decoder_weights(tree, cfg, cpus(2))
    jtree = {"embed": jnp.zeros((92553, 4)), "norm": jnp.ones(4),
             "lm_head": jnp.zeros((4, 92553)), "layers": []}
    with pytest.raises(ValueError, match="92553"):
        jax_shard_decoder_weights(jtree, jax_mesh(2))


def test_decode_graphs_need_every_rank_on_one_card():
    """A decode graph captures one card's stream: ranks on cuda:0 and cuda:1
    with cuda_graphs on are refused (naming the queued item); two ranks on
    cuda:0, or graphs off, pass. No card is needed to decide."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        check_graph_devices([c0, c1], True)
    check_graph_devices([c0, c0], True)
    check_graph_devices([c0, c1], False)
    check_graph_devices([CPU, CPU], True)
