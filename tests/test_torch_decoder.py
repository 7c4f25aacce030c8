"""The port's decoder and memory layers against the JAX package, on the CPU.

tiny-lm in f32 with the JAX random-init weights carried over through numpy
(models/weight_bridge.py): one mixed prefill/decode step must give the same
logits (1e-4: f32, summation order only), tokens, KV cache (1e-5; int8 KV
exactly equal) and token table; then a fused K-step decode window with one
sequence masked early must give the same tokens and cache; a step through
the image-feature and M-RoPE tails of the flat buffer must give the same
logits, tokens and cache. The block
allocator, prefix cache and cache manager must make the same choices as the
JAX ones for the same call sequence.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.memory import TokenCacheBlockManager as JaxTCBM
from hydrainfer_tpu.memory import TokenCacheBlockManagerConfig as JaxTCBMConfig
from hydrainfer_tpu.models.decoder import decoder_forward as jax_decoder_forward
from hydrainfer_tpu.models.decoder import \
    decoder_forward_multi as jax_decoder_forward_multi
from hydrainfer_tpu.models.factory import FillDims as JaxFillDims
from hydrainfer_tpu.models.factory import pack_fill_batch as jax_pack
from hydrainfer_tpu.models.factory import unpack_fill_batch as jax_unpack
from hydrainfer_tpu.models.llama import LlamaForCausalLM as JaxLlama
from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS
from hydrainfer_tpu.models.random_init import init_decoder_weights
from hydrainfer_tpu_torch.memory import (TokenCacheBlockManager,
                                         TokenCacheBlockManagerConfig)
from hydrainfer_tpu_torch.models.decoder import (decoder_forward,
                                                 decoder_forward_multi)
from hydrainfer_tpu_torch.models.factory import (FillDims, pack_fill_batch,
                                                 unpack_fill_batch)
from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM
from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS
from hydrainfer_tpu_torch.models.weight_bridge import from_jax_numpy
from hydrainfer_tpu_torch.ops.quant import QuantizedTensor

BS, NB = 4, 64


def models(quant: str, kv_scale):
    cfg = JAX_ARCHS["tiny-lm"]
    tree = init_decoder_weights(cfg, jax.random.PRNGKey(0), jnp.float32,
                                quantization=quant)
    weights = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    jlm = JaxLlama(tree, cfg, quant, kv_scale=kv_scale)
    return jlm, LlamaForCausalLM(weights, ARCH_CONFIGS["tiny-lm"], quant,
                                 kv_scale=kv_scale)


def mixed_batch():
    """Seq 0: a 6-token prefill (blocks 1-2); seq 1: a chunk of 3 tokens at
    cache positions 4-6 (blocks 3-4); seq 2: one decode token at position 9
    whose input comes from token-table slot 5 (blocks 5-7); padded to T=16,
    S=4. Samples go to table slots 0, 1 and 2."""
    T, S, MB = 16, 4, 4
    specs = [(list(range(6)), [20, 31, 42, 53, 64, 75], [1, 2], -1),
             ([4, 5, 6], [11, 12, 13], [3, 4], -1),
             ([9], [0], [5, 6, 7], 5)]
    tok, pos, seq, loc, slot, src = [], [], [], [], [], []
    kv_lens, tables = np.zeros(S, np.int32), np.full((S, MB), -1, np.int32)
    sample_idx, dst, cu = np.full(S, -1, np.int32), np.full(S, -1, np.int32), [0]
    for s, (cids, toks, blocks, tsrc) in enumerate(specs):
        for i, c in enumerate(cids):
            tok.append(toks[i])
            pos.append(c)
            seq.append(s)
            loc.append(i)
            slot.append(blocks[c // BS] * BS + c % BS)
            src.append(tsrc)
        kv_lens[s] = cids[-1] + 1
        tables[s, :len(blocks)] = blocks
        sample_idx[s] = len(tok) - 1
        dst[s] = s
        cu.append(len(tok))
    cu += [cu[-1]] * (S + 1 - len(cu))

    def pad(v, fill=0):
        a = np.full(T, fill, np.int32)
        a[:len(v)] = v
        return a

    dims = JaxFillDims(T=T, S=S, MB=MB, Ti=0, max_q=T)
    flat = jax_pack(pad(tok), pad(pos), pad(seq, -1), pad(loc), pad(slot, -1),
                    pad(src, -1), kv_lens, sample_idx, dst, tables,
                    np.zeros(0, np.int32), np.zeros(0, np.int32), dims,
                    cu_q_lens=np.asarray(cu, np.int32),
                    num_seqs=np.asarray([3], np.int32))
    return flat, dims, FillDims(T=T, S=S, MB=MB, max_q=T)


def caches(cfg, int8: bool, seed: int = 0):
    shape = (cfg.n_layers, 1, NB, BS, 2 * cfg.n_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(seed)
    if int8:
        c = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        c = rng.standard_normal(shape).astype(np.float32)
    return c


def table0():
    tt = np.zeros(17, np.int32)
    tt[5] = 77                      # seq 2's input token
    return tt


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_mixed_step_matches_jax(quant, kv_scale):
    jlm, lm = models(quant, kv_scale)
    flat, jdims, dims = mixed_batch()
    cache0 = caches(lm.cfg, kv_scale is not None)
    jbatch = jax_unpack(jnp.asarray(flat), jnp.zeros((1, 1, 1, 1, 1, 1)), jdims,
                        lm.cfg.hidden_size)
    jcache, jtt, jtok, jlogits = jax_decoder_forward(
        jlm.weights, jnp.asarray(cache0), jbatch, jlm.cos_tab, jlm.sin_tab,
        jlm.cfg, jdims.max_q, return_logits=True, token_table=jnp.asarray(table0()))

    cache, tt = torch.from_numpy(cache0.copy()), torch.from_numpy(table0())
    tok, logits = decoder_forward(lm.weights, cache, unpack_fill_batch(
        torch.from_numpy(flat), dims), lm.cos_tab, lm.sin_tab, lm.cfg, dims.max_q,
        tt, return_logits=True)
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(jlogits)[:3],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tok[:3].numpy(), np.asarray(jtok)[:3])
    np.testing.assert_array_equal(tt[:16].numpy(), np.asarray(jtt)[:16])
    if kv_scale is None:
        np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_fused_window_matches_jax(quant, kv_scale):
    """A 4-step window over three decoding sequences; sequence 1 stops after
    2 steps (fused_k) and its later state writes are dropped."""
    jlm, lm = models(quant, kv_scale)
    T, S, MB = 8, 4, 4
    kv = [6, 9, 3]                  # cache position of each decode token + 1
    blocks = [[1, 2, 3], [4, 5, 6], [7, 8]]
    tables = np.full((S, MB), -1, np.int32)
    for s, b in enumerate(blocks):
        tables[s, :len(b)] = b
    pos = np.zeros(T, np.int32)
    pos[:3] = [k - 1 for k in kv]
    seq = np.full(T, -1, np.int32)
    seq[:3] = [0, 1, 2]
    slots = np.full(T, -1, np.int32)
    slots[:3] = [blocks[s][(k - 1) // BS] * BS + (k - 1) % BS
                 for s, k in enumerate(kv)]
    src = np.full(T, -1, np.int32)
    src[:3] = [3, 4, 5]
    toks = np.zeros(T, np.int32)
    kv_lens = np.zeros(S, np.int32)
    kv_lens[:3] = kv
    jdims = JaxFillDims(T=T, S=S, MB=MB, Ti=0, max_q=1)
    flat = jax_pack(toks, pos, seq, np.zeros(T, np.int32), slots, src, kv_lens,
                    np.asarray([0, 1, 2, -1], np.int32),
                    np.asarray([3, 4, 5, -1], np.int32), tables,
                    np.zeros(0, np.int32), np.zeros(0, np.int32), jdims,
                    cu_q_lens=np.asarray([0, 1, 2, 3, 3], np.int32),
                    num_seqs=np.asarray([3], np.int32))
    fused_k = np.asarray([4, 2, 4, 0], np.int32)
    tt0 = np.zeros(17, np.int32)
    tt0[3:6] = [101, 202, 303]
    cache0 = caches(lm.cfg, kv_scale is not None, seed=1)

    jbatch = jax_unpack(jnp.asarray(flat), jnp.zeros((1, 1, 1, 1, 1, 1)), jdims,
                        lm.cfg.hidden_size)
    jcache, jtt, jtoks = jax_decoder_forward_multi(
        jlm.weights, jnp.asarray(cache0), jbatch, jlm.cos_tab, jlm.sin_tab,
        jlm.cfg, 4, jnp.asarray(tt0), jnp.asarray(fused_k))
    cache, tt = torch.from_numpy(cache0.copy()), torch.from_numpy(tt0.copy())
    toks = decoder_forward_multi(
        lm.weights, cache, unpack_fill_batch(torch.from_numpy(flat),
                                             FillDims(T=T, S=S, MB=MB)),
        lm.cos_tab, lm.sin_tab, lm.cfg, 4, tt, torch.from_numpy(fused_k))
    live = np.asarray([[True, True, True]] * 2 + [[True, False, True]] * 2)
    np.testing.assert_array_equal(toks[:, :3].numpy()[live],
                                  np.asarray(jtoks)[:, :3][live])
    np.testing.assert_array_equal(tt[:16].numpy(), np.asarray(jtt)[:16])
    if kv_scale is None:
        np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))


def test_weight_bridge_keeps_values_and_the_source_tree():
    tree = init_decoder_weights(JAX_ARCHS["tiny-lm"], jax.random.PRNGKey(1),
                                jnp.bfloat16, quantization="int8")
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    w = from_jax_numpy(np_tree, "cpu")
    assert w["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(w["embed"].float().numpy(),
                                  np.asarray(tree["embed"], np.float32))
    qkv = w["layers"][1]["qkv_proj"]
    assert isinstance(qkv, QuantizedTensor) and qkv.q.dtype == torch.int8
    np.testing.assert_array_equal(qkv.q.numpy(),
                                  np.asarray(tree["layers"][1]["qkv_proj"].q))
    assert "qkv_bias" not in w["layers"][0]
    assert len(np_tree["layers"]) == 2           # the bridge consumed nothing


def test_cache_manager_matches_jax_manager():
    cfg = dict(n_layers=2, n_tensors=1, n_blocks=12, block_size=4, n_heads=4,
               head_dim=8, dtype="float32")
    port = TokenCacheBlockManager(TokenCacheBlockManagerConfig(**cfg), "cpu")
    ref = JaxTCBM(JaxTCBMConfig(**cfg))
    assert port.cache_array.shape == tuple(ref.cache_array.shape)
    log_p, log_j = [], []
    for mgr, log in ((port, log_p), (ref, log_j)):
        a = mgr.allocate_virtual_cache([11, 12, 13])
        mgr.realloc(a, 10)
        mgr.set_blocks(a, [0, 1], [11, 12])
        b = mgr.allocate_virtual_cache([11, 12, 99])   # 2-block prefix hit
        mgr.realloc(b, 13)
        log.append((list(a.block_table), list(b.block_table), b.n_cache_tokens))
        mgr.realloc(a, 0)
        c = mgr.allocate_virtual_cache()
        mgr.realloc(c, 30)                              # evicts cold blocks
        log.append((list(c.block_table), mgr.n_available_blocks(),
                    mgr.v2p(b, [0, 5, 12]), mgr.metrics().prefix_cache_hit_rate))
    assert log_p == log_j


@pytest.mark.parametrize("quant,kv_scale", [("none", None), ("int8", 0.05)],
                         ids=["f32", "int8w_int8kv"])
def test_image_and_mrope_step_matches_jax(quant, kv_scale):
    """One step through the flat buffer's image and M-RoPE tails: sequence 0
    is a 10-token prefill whose tokens 2-5 are a 2x2 image (features gathered
    from an image cache, four padding rows with destination -1), its text
    after the image at compressed rope positions; sequence 1 a decode whose
    rope position lags its cache position."""
    from dataclasses import replace
    from hydrainfer_tpu.models.llama import LlamaForCausalLM as JaxLlama
    cfg, jcfg = (replace(c, mrope_section=(4, 6, 6))
                 for c in (ARCH_CONFIGS["tiny-lm"], JAX_ARCHS["tiny-lm"]))
    tree = init_decoder_weights(jcfg, jax.random.PRNGKey(2), jnp.float32,
                                quantization=quant)
    weights = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    jlm = JaxLlama(tree, jcfg, quant, kv_scale=kv_scale)
    lm = LlamaForCausalLM(weights, cfg, quant, kv_scale=kv_scale)

    T, S, MB, Ti = 16, 2, 4, 8
    pad = lambda v, n=T, fill=0: np.asarray(list(v) + [fill] * (n - len(v)), np.int32)
    pt = [0, 1, 2, 2, 2, 2, 4, 5, 6, 7, 5]
    ph = [0, 1, 2, 2, 3, 3, 4, 5, 6, 7, 5]
    pw = [0, 1, 2, 3, 2, 3, 4, 5, 6, 7, 5]
    tables = np.full((S, MB), -1, np.int32)
    tables[0, :3], tables[1, :2] = [1, 2, 3], [5, 6]
    slots = [tables[0, c // BS] * BS + c % BS for c in range(10)] + [6 * BS + 2]
    flat = pack_fill_batch(
        pad([20, 31, 9, 9, 9, 9, 42, 53, 64, 75, 0]), pad(pt),
        pad([0] * 10 + [1], fill=-1), pad(list(range(10)) + [0]), pad(slots, fill=-1),
        pad([-1] * 10 + [5], fill=-1), np.asarray([10, 7], np.int32),
        np.asarray([9, 10], np.int32), np.asarray([0, 1], np.int32), tables,
        np.asarray([0, 10, 11], np.int32), np.asarray([2], np.int32),
        image_slot_ids=pad([5, 6, 7, 8], Ti), image_dst_idx=pad([2, 3, 4, 5], Ti, -1),
        positions_hw=np.stack([pad(ph), pad(pw)]))
    image_cache = np.random.default_rng(3).standard_normal(
        (1, 1, 4, 4, cfg.n_qo_heads, cfg.head_dim)).astype(np.float32)
    cache0 = caches(cfg, kv_scale is not None, seed=2)

    jdims = JaxFillDims(T=T, S=S, MB=MB, Ti=Ti, max_q=T, mrope=True)
    jbatch = jax_unpack(jnp.asarray(flat), jnp.asarray(image_cache), jdims, cfg.hidden_size)
    jcache, jtt, jtok, jlogits = jax_decoder_forward(
        jlm.weights, jnp.asarray(cache0), jbatch, jlm.cos_tab, jlm.sin_tab, jlm.cfg, T,
        return_logits=True, token_table=jnp.asarray(table0()))
    cache, tt = torch.from_numpy(cache0.copy()), torch.from_numpy(table0())
    batch = unpack_fill_batch(torch.from_numpy(flat),
                              FillDims(T=T, S=S, MB=MB, max_q=T, Ti=Ti, mrope=True),
                              torch.from_numpy(image_cache), cfg.hidden_size)
    tok, logits = decoder_forward(lm.weights, cache, batch, lm.cos_tab, lm.sin_tab,
                                  lm.cfg, T, tt, return_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jtt))
    if kv_scale is None:
        np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
