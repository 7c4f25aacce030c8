"""The port's pipeline parallelism (parallel/pipeline.py) against the JAX
package's, on the CPU: the JAX side on the conftest's 8-device CPU mesh
(tests/parallel/test_pipeline.py's 4-layer config and batches), the port's
stages on a list of CPU devices, the same f32 weights carried over through
numpy.

- the relay (`decoder_forward_pp`) at pp 2 and 4 on a mixed prefill and
  decode batch, then a decode step that reads the first step's tokens from
  the token table; pp 4 over 4 layers gives every stage one layer, so each
  kernel call's layer id is the local id 0, which a wrong offset would turn
  into another layer's pages;
- the microbatched decode (`decoder_forward_pp_decode`) at pp 2 and 4 on a
  pure decode batch with padded rows (kv_len 0), one microbatch of pp 4
  all padding;
- TP inside the stages (pp 2 x tp 2) against JAX's pp_tp forms, both
  schedules;
- the refusals, beside the JAX package's: a layer count the stage count
  does not divide, layers whose weight keys differ, quantized weights
  under TP inside the stages;
- the cache's stage shards: shard, merge and the block payload of a
  migration between PP degrees.

Tokens and the token table must match exactly, the cache within 1e-5.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from hydrainfer_tpu.models.decoder import init_rope_tables as jax_rope_tables
from hydrainfer_tpu.models.factory import LanguageModelBatch as JaxBatch
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu.ops.attention import PagedAttentionParams as JaxParams
from hydrainfer_tpu.parallel.mesh import make_mesh
from hydrainfer_tpu.parallel.pipeline import (decoder_forward_pp as jax_forward_pp,
                                              decoder_forward_pp_decode as jax_forward_pp_decode,
                                              pp_pack_weights, pp_shard_cache,
                                              pp_shard_weights, pp_tp_pack_weights)
from hydrainfer_tpu_torch.memory.token_cache import (TokenCacheBlockManager,
                                                     TokenCacheBlockManagerConfig)
from hydrainfer_tpu_torch.models.decoder import DecoderConfig, init_rope_tables
from hydrainfer_tpu_torch.models.factory import LanguageModelBatch
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams
from hydrainfer_tpu_torch.parallel.mesh import merge_kv_shards, shard_kv_cache
from hydrainfer_tpu_torch.parallel.pipeline import (decoder_forward_pp,
                                                    decoder_forward_pp_decode,
                                                    pp_split_layers, pp_stages)

BLOCK = 4
N_BLOCKS = 32
CFG = dict(n_layers=4, hidden_size=64, intermediate_size=128, n_qo_heads=4, n_kv_heads=2,
           head_dim=16, vocab_size=256, max_position_embeddings=64)
TOL = dict(rtol=1e-5, atol=1e-5)
_STEP = {}


def jit(fn, *static):
    """One jitted JAX function a module (the compile is the test's cost)."""
    if fn not in _STEP:
        _STEP[fn] = jax.jit(fn, static_argnames=static)
    return _STEP[fn]


def weights(seed: int, quantization: str = "none"):
    """tiny 4-layer f32 weights: the JAX tree and the port's dict."""
    tree = init_decoder_weights(JaxDecoderConfig(**CFG), jax.random.PRNGKey(seed), jnp.float32,
                                quantization=quantization)
    return tree, from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def batches(fields: dict, batch: dict):
    """The same step for both packages from numpy fields."""
    jb = JaxBatch(attention=JaxParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
                  image_features=jnp.zeros((0, CFG["hidden_size"]), jnp.float32),
                  image_dst_idx=jnp.zeros((0,), jnp.int32),
                  **{k: jnp.asarray(v) for k, v in batch.items()})
    pb = LanguageModelBatch(attention=PagedAttentionParams(
        **{k: torch.from_numpy(v) for k, v in fields.items()}),
        **{k: torch.from_numpy(v) for k, v in batch.items()})
    return jb, pb


def mixed_batch():
    """test_pipeline.py's make_batch: a 6-token prefill and a 2-token chunk."""
    q_seq = np.array([0] * 6 + [1] * 2, np.int32)
    pos = np.array([0, 1, 2, 3, 4, 5, 4, 5], np.int32)
    tables = np.full((2, 4), -1, np.int32)
    tables[0, :2], tables[1, :2] = [0, 1], [2, 3]
    slots = (tables[q_seq, pos // BLOCK] * BLOCK + pos % BLOCK).astype(np.int32)
    return batches(
        dict(q_seq_ids=q_seq, q_local_ids=np.array([0, 1, 2, 3, 4, 5, 0, 1], np.int32),
             positions=pos, kv_lens=np.array([6, 6], np.int32), block_tables=tables,
             new_kv_slot_ids=slots, cu_q_lens=np.array([0, 6, 8], np.int32),
             num_seqs=np.array([2], np.int32)),
        dict(token_ids=np.arange(8, dtype=np.int32) + 5, positions=pos,
             sample_token_idx=np.array([5, 7], np.int32),
             token_src_slots=np.full(8, -1, np.int32),
             sample_dst_slots=np.array([0, 1], np.int32)))


def feedback_batch():
    """test_pipeline.py's second step: each sequence decodes the token the
    first step wrote to its table slot."""
    pos = np.array([6, 6, 0, 0, 0, 0, 0, 0], np.int32)
    tables = np.full((2, 4), -1, np.int32)
    tables[0, :2], tables[1, :2] = [0, 1], [2, 3]
    slots = np.full(8, -1, np.int32)
    slots[:2] = tables[[0, 1], 6 // BLOCK] * BLOCK + 6 % BLOCK
    return batches(
        dict(q_seq_ids=np.array([0, 1] + [-1] * 6, np.int32),
             q_local_ids=np.zeros(8, np.int32), positions=pos,
             kv_lens=np.array([7, 7], np.int32), block_tables=tables, new_kv_slot_ids=slots,
             cu_q_lens=np.array([0, 1, 2], np.int32), num_seqs=np.array([2], np.int32)),
        dict(token_ids=np.zeros(8, np.int32), positions=pos,
             sample_token_idx=np.array([0, 1], np.int32),
             token_src_slots=np.array([0, 1] + [-1] * 6, np.int32),
             sample_dst_slots=np.array([0, 1], np.int32)))


def decode_batch(kv_lens, seed: int):
    """A pure decode batch (row s = sequence s) over a cache holding each
    live sequence's context; padded rows have kv_len 0."""
    kv_lens = np.asarray(kv_lens, np.int32)
    S = len(kv_lens)
    tables = np.full((S, 4), -1, np.int32)
    cache = np.zeros((CFG["n_layers"], 1, N_BLOCKS, BLOCK, 2 * CFG["n_kv_heads"],
                      CFG["head_dim"]), np.float32)
    rng, bid = np.random.default_rng(seed), 0
    for s in range(S):
        if kv_lens[s] == 0:
            continue
        nb = -(-int(kv_lens[s]) // BLOCK)
        tables[s, :nb] = range(bid, bid + nb)
        bid += nb
        for p in range(int(kv_lens[s]) - 1):
            cache[:, 0, tables[s, p // BLOCK], p % BLOCK] = 0.3 * rng.standard_normal(
                (CFG["n_layers"], 2 * CFG["n_kv_heads"], CFG["head_dim"]))
    live = kv_lens > 0
    pos = np.where(live, kv_lens - 1, 0).astype(np.int32)
    slots = np.where(live, tables[np.arange(S), pos // BLOCK] * BLOCK + pos % BLOCK,
                     -1).astype(np.int32)
    jb, pb = batches(
        dict(q_seq_ids=np.where(live, np.arange(S), -1).astype(np.int32),
             q_local_ids=np.zeros(S, np.int32), positions=pos, kv_lens=kv_lens,
             block_tables=tables, new_kv_slot_ids=slots,
             cu_q_lens=np.minimum(np.arange(S + 1), live.sum()).astype(np.int32),
             num_seqs=np.array([live.sum()], np.int32)),
        dict(token_ids=(np.arange(S) % 50 + 3).astype(np.int32), positions=pos,
             sample_token_idx=np.arange(S, dtype=np.int32),
             token_src_slots=np.full(S, -1, np.int32),
             sample_dst_slots=np.where(live, np.arange(S), -1).astype(np.int32)))
    return jb, pb, cache


def jax_mesh(pp: int, tp: int = 1):
    if tp == 1:
        return make_mesh(8, axis_names=("dp", "pp"), shape=(8 // pp, pp))
    return make_mesh(8, axis_names=("dp", "pp", "tp"), shape=(8 // (pp * tp), pp, tp))


def jax_stage_weights(tree, mesh, pp: int, tp: int):
    if tp == 1:
        return pp_shard_weights(pp_pack_weights(tree, pp), mesh)
    return pp_shard_weights(pp_tp_pack_weights(tree, pp, tp, JaxDecoderConfig(**CFG)), mesh)


def port_stages(w, pp: int, tp: int = 1):
    return pp_stages(w, DecoderConfig(**CFG), ["cpu"] * (pp * tp), tp)


def port_shard_cache(cache: torch.Tensor, stages):
    """The cache as the stages' shards (their layer runs)."""
    return shard_kv_cache(cache, stages.cache_shards())


def pp_merge_cache(caches, stages) -> torch.Tensor:
    return merge_kv_shards(caches, stages.cache_shards())


def check(cache_pp, table_pp, tok_pp, caches, table, tok, stages):
    assert np.array_equal(tok.numpy(), np.asarray(tok_pp))
    # the port's token table ends in a discard slot that padded rows write
    # (models/decoder.py:_final_head); the JAX scatter drops them
    assert np.array_equal(table.numpy()[:-1], np.asarray(table_pp)[:-1])
    ref = np.asarray(cache_pp)
    np.testing.assert_allclose(pp_merge_cache(caches, stages).numpy(), ref.reshape(
        (CFG["n_layers"],) + ref.shape[-5:]), **TOL)


@pytest.mark.parametrize("pp,tp", [(2, 1), (4, 1), (2, 2)], ids=["pp2", "pp4", "pp2_tp2"])
def test_relay_matches_jax_pipeline(pp, tp):
    """A mixed prefill step, then a decode step fed from the token table,
    through the relay of both packages."""
    tree, w = weights(0)
    stages = port_stages(w, pp, tp)
    assert [st.first for st in stages.stages] == list(range(0, 4, 4 // pp))
    mesh = jax_mesh(pp, tp)
    jw = jax_stage_weights(tree, mesh, pp, tp)
    cache = np.zeros((4, 1, N_BLOCKS, BLOCK, 2 * CFG["n_kv_heads"], CFG["head_dim"]),
                     np.float32)
    jcache = pp_shard_cache(jnp.asarray(cache), mesh)
    caches = port_shard_cache(torch.from_numpy(cache), stages)
    jcos, jsin = jax_rope_tables(JaxDecoderConfig(**CFG))
    cos, sin = init_rope_tables(DecoderConfig(**CFG))
    jtable, table = jnp.zeros((8,), jnp.int32), torch.zeros(8, dtype=torch.int32)
    step = jit(jax_forward_pp, "cfg", "max_q", "mesh")
    for (jb, pb), max_q in ((mixed_batch(), 8), (feedback_batch(), 1)):
        jcache, jtable, jtok = step(jw, jcache, jb, jcos, jsin, JaxDecoderConfig(**CFG),
                                    max_q=max_q, token_table=jtable, mesh=mesh)
        tok = decoder_forward_pp(stages, caches, pb, cos, sin, max_q, table)
        check(jcache, jtable, jtok, caches, table, tok, stages)


@pytest.mark.parametrize("pp,tp,kv_lens", [
    (2, 1, [3, 5, 2, 7, 4, 6, 0, 0]), (4, 1, [3, 5, 2, 7, 4, 6, 0, 0]),
    (2, 2, [5, 6, 7, 8])], ids=["pp2", "pp4", "pp2_tp2"])
def test_microbatched_decode_matches_jax_pipeline(pp, tp, kv_lens):
    """The GPipe decode step: pp microbatches of S / pp rows; at pp 4 the
    last microbatch is all padding."""
    tree, w = weights(2)
    stages = port_stages(w, pp, tp)
    mesh = jax_mesh(pp, tp)
    jb, pb, cache = decode_batch(kv_lens, seed=8)
    jcos, jsin = jax_rope_tables(JaxDecoderConfig(**CFG))
    cos, sin = init_rope_tables(DecoderConfig(**CFG))
    step = jit(jax_forward_pp_decode, "cfg", "mesh", "n_micro")
    jcache, jtable, jtok = step(jax_stage_weights(tree, mesh, pp, tp),
                                pp_shard_cache(jnp.asarray(cache), mesh), jb, jcos, jsin,
                                JaxDecoderConfig(**CFG), token_table=jnp.zeros((8,), jnp.int32),
                                mesh=mesh, n_micro=pp)
    caches = port_shard_cache(torch.from_numpy(cache), stages)
    table = torch.zeros(8, dtype=torch.int32)
    tok = decoder_forward_pp_decode(stages, caches, pb, cos, sin, table, pp)
    check(jcache, jtable, jtok, caches, table, tok, stages)


def test_refusals_match_jax():
    """A stage count that does not divide the layers, a layer whose weight
    keys differ from layer 0's (a MoE model's dense first layers), and
    quantized projections under TP inside the stages: refused by both
    packages (JAX asserts or raises NotImplementedError)."""
    tree, w = weights(0)
    with pytest.raises(AssertionError, match="not divisible"):
        pp_pack_weights(tree, 3)
    with pytest.raises(NotImplementedError, match="4 layers do not split into 3"):
        pp_split_layers(w["layers"], 3)
    router = np.zeros((CFG["hidden_size"], 8), np.float32)
    jlayers = [dict(lw, moe_router=jnp.asarray(router)) if i else lw
               for i, lw in enumerate(tree["layers"])]
    with pytest.raises(AssertionError, match="uniform layer signature"):
        pp_pack_weights(dict(tree, layers=jlayers), 2)
    layers = [dict(lw, moe_router=torch.from_numpy(router)) if i else lw
              for i, lw in enumerate(w["layers"])]
    with pytest.raises(NotImplementedError, match=r"layer 1's weights and layer 0's differ "
                                                  r"in \['moe_router'\]"):
        pp_split_layers(layers, 2)
    qtree, qw = weights(0, "int8")
    with pytest.raises(NotImplementedError, match="quantized"):
        pp_tp_pack_weights(qtree, 2, 2, JaxDecoderConfig(**CFG))
    with pytest.raises(NotImplementedError, match="quantized qkv_proj"):
        port_stages(qw, 2, 2)
    # without TP a quantized model splits, its stages holding its tensors
    stage = port_stages(qw, 2).stages[1]
    assert stage.first == 2 and stage.ranks[0][0]["qkv_proj"].q is qw["layers"][2]["qkv_proj"].q


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2), (4, 1)], ids=["pp2", "pp2_tp2", "pp4"])
def test_stage_cache_shards_round_trip(pp, tp):
    """The stage shards of a cache (layer runs, and under TP each rank's
    heads) merge back to it, and a block manager over them gathers and
    scatters payloads in the single-device layout, so blocks migrate
    between PP degrees: P at pp -> D at 1 and back."""
    _, w = weights(0)
    stages = port_stages(w, pp, tp)
    shards = stages.cache_shards()
    assert [(s.layer0, s.layers) for s in shards] == [
        (st.first, 4 // pp) for st in stages.stages for _ in range(tp)]
    cache = torch.randn(4, 1, 6, BLOCK, 4, 16)
    assert torch.equal(pp_merge_cache(port_shard_cache(cache, stages), stages), cache)
    cfg = TokenCacheBlockManagerConfig(n_layers=4, n_blocks=6, block_size=BLOCK, n_heads=4,
                                       head_dim=16, dtype="fp32")
    staged = TokenCacheBlockManager(cfg, "cpu", shards=shards)
    single = TokenCacheBlockManager(cfg, "cpu")
    assert [tuple(a.shape[:1]) + tuple(a.shape[-2:]) for a in staged.cache_array] == \
        [(4 // pp, 4 // tp, 16)] * (pp * tp)
    payload = cache[:, :, [1, 4]].movedim(2, 0)
    staged.scatter_blocks([3, 0], payload)
    assert torch.equal(staged.gather_blocks([3, 0]), payload)
    single.scatter_blocks([2, 5], staged.gather_blocks([3, 0]))
    assert torch.equal(single.cache_array[:, :, [2, 5]], cache[:, :, [1, 4]])
    staged.scatter_blocks([1], single.gather_blocks([5]))
    assert torch.equal(staged.gather_blocks([1]), payload[1:])
