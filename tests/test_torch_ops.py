"""The port's plain ops against their JAX counterparts, on the CPU.

Inputs are made from a seed with numpy and fed to both packages. Tolerances:
f32 elementwise ops and f32 matmuls agree to 1e-5 (only the summation order
differs); int8 quantization and cache writes agree exactly. The kernel-bearing
modules (K3 kv writer, K4 int8 GEMM) are held against the JAX Pallas kernels
run in interpret mode, as the JAX package's own tests run them (K5 has its
own file, test_torch_mha_varlen.py). The ViT's layer_norm, quick_gelu and
exact GELU, and the image-feature scatter write_token_cache, are held here
too.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.models.decoder import init_rope_tables as jax_rope_tables
from hydrainfer_tpu.models.random_init import ARCH_CONFIGS as JAX_ARCHS
from hydrainfer_tpu.ops import activation as jact
from hydrainfer_tpu.ops import cache_ops as jcache
from hydrainfer_tpu.ops import norm as jnorm
from hydrainfer_tpu.ops import quant as jquant
from hydrainfer_tpu.ops import rope as jrope
from hydrainfer_tpu.ops.pallas.kv_writer import write_kv_pages as jax_write_kv_pages
from hydrainfer_tpu.ops.pallas.quant_matmul import quant_matmul_int8 as jax_qmm
from hydrainfer_tpu_torch.models.decoder import init_rope_tables
from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS
from hydrainfer_tpu_torch.ops import activation, cache_ops, norm, quant, rope
from hydrainfer_tpu_torch.ops.cuda import (launch_counts, mha_varlen_flash,
                                           quant_matmul_int8, reset_launch_counts,
                                           write_kv_pages)

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    close(norm.rms_norm(t(x), t(w), 1e-6), jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_silu_and_mul():
    x = np.random.default_rng(1).standard_normal((5, 48)).astype(np.float32)
    close(activation.silu_and_mul(t(x)), jact.silu_and_mul(jnp.asarray(x)))


@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rotary_emb(interleaved):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 3, 32)).astype(np.float32)
    ang = rng.uniform(0, 6, (6, 12)).astype(np.float32)   # rotary_dim 24 < 32
    cos, sin = np.cos(ang), np.sin(ang)
    close(rope.apply_rotary_emb(t(x), t(cos), t(sin), interleaved),
          jrope.apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin),
                                 interleaved))


def test_inv_freq_and_rope_tables():
    close(rope.compute_default_inv_freq(32, 10000.0),
          jrope.compute_default_inv_freq(32, 10000.0))
    cos, sin = init_rope_tables(ARCH_CONFIGS["tiny-lm"])
    jcos, jsin = jax_rope_tables(JAX_ARCHS["tiny-lm"])
    # angles up to 2047 rad: the two libraries' f32 cos/sin differ by ulps
    close(cos, jcos)
    close(sin, jsin)


def test_quantize_int8_and_dequantize():
    w = (np.random.default_rng(3).standard_normal((64, 48)) * 0.1).astype(np.float32)
    qt, jqt = quant.quantize_int8(t(w)), jquant.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jqt.q))
    # amax / 127 may round 1 ulp apart (XLA divides through a reciprocal)
    close(qt.scale, jqt.scale, rtol=1e-6, atol=0)
    close(quant.dequantize(qt, torch.float32),
          jquant.dequantize(jqt, jnp.float32), rtol=1e-6, atol=0)


def test_quantize_tree_is_idempotent_and_keeps_the_caller_tree():
    rng = np.random.default_rng(4)
    layer = {k: t(rng.standard_normal((8, 8)).astype(np.float32))
             for k in ("qkv_proj", "o_proj", "gate_up", "down", "input_norm")}
    tree = {"layers": [layer], "lm_head": t(rng.standard_normal((8, 16)).astype(np.float32))}
    out = quant.quantize_tree(tree, "int8")
    assert isinstance(out["lm_head"], quant.QuantizedTensor)
    assert isinstance(out["layers"][0]["down"], quant.QuantizedTensor)
    assert isinstance(out["layers"][0]["input_norm"], torch.Tensor)
    assert isinstance(tree["layers"][0]["down"], torch.Tensor)   # not consumed
    again = quant.quantize_tree(out, "int8")
    assert again["lm_head"] is out["lm_head"]


@pytest.mark.parametrize("M,K,N", [(1, 128, 96), (5, 256, 200), (33, 128, 384)])
def test_qmatmul_matches_jax(M, K, N):
    """K4's module: qmatmul / qmatmul_f32 (plain version on the CPU) against
    the JAX XLA path and the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    jqt = jquant.quantize_int8(jnp.asarray(w))
    qt = quant.QuantizedTensor(t(jqt.q), t(jqt.scale))
    ref = jquant.qmatmul(jnp.asarray(x), jqt)
    close(quant.qmatmul(t(x), qt), ref)
    close(quant.qmatmul_f32(t(x), qt), jquant.qmatmul_f32(jnp.asarray(x), jqt))
    if K % 128 == 0 and N % 128 == 0:
        pallas = jax_qmm(jnp.asarray(x), jqt.q, jqt.scale, block_k=128,
                         block_n=128, interpret=True)
        close(quant_matmul_int8(t(x), qt.q, qt.scale), pallas)
    # plain weights pass straight through
    close(quant.qmatmul(t(x), t(w)), jnp.asarray(x) @ jnp.asarray(w))


def _kv_case(rng, T, pattern, bs=4, nb=16, kvh=2, d=8, L=2):
    cache0 = rng.standard_normal((L, 1, nb, bs, 2 * kvh, d)).astype(np.float32)
    k = rng.standard_normal((T, kvh, d)).astype(np.float32)
    v = rng.standard_normal((T, kvh, d)).astype(np.float32)
    if pattern == "prefill":
        slots = np.arange(2 * bs, 2 * bs + T, dtype=np.int32)
        seqs = np.zeros(T, np.int32)
    elif pattern == "decode":
        slots = rng.choice(nb * bs, size=T, replace=False).astype(np.int32)
        seqs = np.arange(T, dtype=np.int32)
    else:   # mixed: a mid-block chunk, one decode token, one padded token
        slots = np.concatenate([np.arange(bs + 2, bs + T, dtype=np.int32),
                                [7 * bs + 1, -1]]).astype(np.int32)
        seqs = np.concatenate([np.zeros(T - 2, np.int32), [1, -1]]).astype(np.int32)
    return cache0, k, v, slots, seqs


@pytest.mark.parametrize("pattern,T", [("prefill", 12), ("prefill", 10),
                                       ("decode", 6), ("mixed", 9), ("decode", 3)])
def test_write_kv_pages_matches_pallas_writer(pattern, T):
    """K3 (plain version on the CPU) against the JAX Pallas writer in interpret
    mode: identical caches, written in place on the port side."""
    rng = np.random.default_rng(6)
    cache0, k, v, slots, seqs = _kv_case(rng, T, pattern)
    kv = jnp.concatenate([jnp.asarray(k)[:, :, None], jnp.asarray(v)[:, :, None]],
                         axis=2).reshape(T, -1, k.shape[-1])
    ref = jax_write_kv_pages(jnp.asarray(cache0), kv, jnp.asarray(1, jnp.int32),
                             jnp.asarray(slots), jnp.asarray(seqs),
                             block_size=4, interpret=True)
    cache = t(cache0)
    out = write_kv_pages(cache[1, 0], t(k), t(v), t(slots))
    assert out.data_ptr() == cache[1, 0].data_ptr()      # in place
    np.testing.assert_array_equal(cache.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kv_scale", [None, 0.05])
def test_write_kv_cache_matches_jax(kv_scale):
    """cache_ops.write_kv_cache, with the int8 quantize of
    models/decoder.py:_write_kv fused in when kv_scale is set."""
    rng = np.random.default_rng(7)
    cache0, k, v, slots, _ = _kv_case(rng, 9, "mixed")
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if kv_scale is not None:
        cache0 = np.zeros(cache0.shape, np.int8)
        jk = jnp.clip(jnp.round(jk / kv_scale), -127, 127).astype(jnp.int8)
        jv = jnp.clip(jnp.round(jv / kv_scale), -127, 127).astype(jnp.int8)
    ref = jcache.write_kv_cache(jnp.asarray(cache0), 0, jnp.asarray(slots), jk, jv, 4)
    # a strided V (a slice of a fused qkv row), as the decoder passes it
    qkv = np.concatenate([k.reshape(9, -1), v.reshape(9, -1)], axis=1)
    v_view = t(qkv)[:, k.shape[1] * k.shape[2]:].reshape(v.shape)
    cache = t(cache0)
    cache_ops.write_kv_cache(cache, 0, t(slots), t(k), v_view, kv_scale)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(ref))


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    reset_launch_counts()
    rng = np.random.default_rng(8)
    x = t(rng.standard_normal((3, 16)).astype(np.float32))
    q = t(rng.integers(-127, 128, (16, 8)).astype(np.int8))
    quant_matmul_int8(x, q, torch.ones(8))
    cache0, k, v, slots, _ = _kv_case(rng, 6, "decode")
    write_kv_pages(t(cache0)[0, 0], t(k), t(v), t(slots))
    qkv = t(rng.standard_normal((5, 3, 2, 16)).astype(np.float32))
    mha_varlen_flash(qkv[:, 0], qkv[:, 1], qkv[:, 2], t(np.zeros(5, np.int32)), 0.25)
    assert all(n == 0 for n in launch_counts().values())


def test_layer_norm():
    rng = np.random.default_rng(9)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((7, 80), 80, 80))
    close(norm.layer_norm(t(x), t(w), t(b), 1e-6),
          jnorm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6))


def test_quick_gelu_and_exact_gelu():
    import jax
    x = np.random.default_rng(10).standard_normal((5, 40)).astype(np.float32) * 3
    close(activation.quick_gelu(t(x)), jact.quick_gelu(jnp.asarray(x)))
    close(activation.gelu_exact(t(x)), jax.nn.gelu(jnp.asarray(x), approximate=False))


def test_write_token_cache_matches_jax():
    """The image-feature scatter: one tensor, padding slots (-1) dropped
    (JAX maps them out of range; a negative index would wrap)."""
    rng = np.random.default_rng(11)
    cache0 = rng.standard_normal((1, 1, 5, 6, 4, 8)).astype(np.float32)
    vals = rng.standard_normal((9, 4, 8)).astype(np.float32)
    slots = rng.permutation(30)[:9].astype(np.int32)
    slots[[2, 7]] = -1
    ref = jcache.write_token_cache(jnp.asarray(cache0), 0, jnp.asarray(slots),
                                   (jnp.asarray(vals),), 6)
    cache = t(cache0)
    cache_ops.write_token_cache(cache, 0, t(slots), t(vals))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(ref))
