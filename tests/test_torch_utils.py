"""The port's utils against the JAX package's: debug, profiler, statistic, image_utils.

The same probes recorded through hydrainfer_tpu/utils/debug.py (inside a
jitted function, by jax.debug.callback) and hydrainfer_tpu_torch/utils/
debug.py dump to .npz files of one layout (`name.i`): either package's
`compare` finds every entry "ok", and a changed value "DIFF". A port probe
keeps a detached CPU copy (bf16 as f32), and one made while a CUDA graph
captures raises (here the capture is simulated; tests/test_torch_kernels_
cuda.py captures on the card). The profiler's totals count the spans as
JAX's do, and its report has the same lines; statistic's sparsity and
image_utils' random image equal the JAX functions' on the same inputs, and
the plots write their files.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.utils import debug as jdebug
from hydrainfer_tpu.utils import image_utils as jimage
from hydrainfer_tpu.utils import profiler as jprofiler
from hydrainfer_tpu.utils import statistic as jstatistic
from hydrainfer_tpu_torch.utils import debug, image_utils, profiler, statistic


@pytest.fixture
def probes(monkeypatch):
    for mod in (debug, jdebug):
        monkeypatch.setattr(mod, "_ENABLED", True)
        monkeypatch.setattr(mod, "_REGISTRY", {})
    return debug, jdebug


def _layers(rng, n=3):
    return [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(n)]


def test_port_and_jax_dumps_compare_ok(probes, tmp_path):
    rng = np.random.default_rng(0)
    hs, logits = _layers(rng), rng.standard_normal((2, 16)).astype(np.float32)

    @jax.jit
    def jax_model(hs, logits):
        for h in hs:
            jdebug.probe("hidden", h * 2.0)
        return jdebug.probe("logits", logits)

    jax.block_until_ready(jax_model([jnp.asarray(h) for h in hs], jnp.asarray(logits)))
    for h in hs:
        assert debug.probe("hidden", torch.from_numpy(h) * 2.0) is not None
    debug.probe("logits", torch.from_numpy(logits))
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jdebug.dump(a)
    debug.dump(b)
    assert sorted(np.load(a).files) == sorted(np.load(b).files) == \
        ["hidden.0", "hidden.1", "hidden.2", "logits.0"]
    for rows in (debug.compare(a, b), jdebug.compare(a, b), debug.compare_with(a)):
        assert [r["status"] for r in rows] == ["ok"] * 4
    debug.clear()
    debug.probe("hidden", torch.from_numpy(hs[0]))          # not doubled
    rows = debug.compare_with(a)
    assert [r["status"] for r in rows] == ["DIFF", "only_in_a", "only_in_a", "only_in_a"]
    assert debug.stats("hidden")[0]["shape"] == (4, 8)


def test_probe_keeps_a_detached_cpu_copy(probes):
    x = torch.ones(3, requires_grad=True)
    assert debug.probe("x", x) is x
    x.data.fill_(5.0)
    (kept,) = debug._REGISTRY["x"]
    assert isinstance(kept, np.ndarray) and (kept == 1.0).all()
    debug.probe("b", torch.full((2,), 1.5, dtype=torch.bfloat16))
    assert debug._REGISTRY["b"][0].dtype == np.float32


def test_probe_is_a_no_op_when_off(monkeypatch):
    monkeypatch.setattr(debug, "_ENABLED", False)
    monkeypatch.setattr(debug, "_REGISTRY", {})
    debug.probe("x", torch.ones(2))
    assert debug._REGISTRY == {}


def test_probe_raises_inside_a_graph_capture(probes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        debug.probe("x", torch.ones(2))
    assert debug._REGISTRY == {}


def test_profiler_totals_match_jax(monkeypatch):
    got = {}
    for mod in (profiler, jprofiler):
        monkeypatch.setattr(mod, "_enabled", True)
        monkeypatch.setattr(mod, "_totals", type(mod._totals)(lambda: (0.0, 0)))
        for name, n in (("step", 3), ("read", 2)):
            for _ in range(n):
                with mod.span(name):
                    pass
        lines = []
        monkeypatch.setattr(mod.logger, "info", lines.append)
        mod._report()
        got[mod] = ({k: n for k, (_, n) in mod._totals.items()},
                    [line.split(":")[0] for line in lines[0].splitlines()])
    assert got[profiler][0] == got[jprofiler][0] == {"step": 3, "read": 2}
    assert sorted(got[profiler][1]) == sorted(got[jprofiler][1])
    monkeypatch.setattr(profiler, "_enabled", False)
    monkeypatch.setattr(profiler, "_totals", type(profiler._totals)(lambda: (0.0, 0)))
    with profiler.span("off"):
        pass
    assert dict(profiler._totals) == {}


@pytest.mark.parametrize("threshold", [0.01, 0.1, 0.5])
def test_attention_sparsity_matches_jax(threshold):
    scores = np.random.default_rng(1).random((4, 16, 16)).astype(np.float32) ** 4
    assert statistic.attention_sparsity(scores, threshold) == \
        jstatistic.attention_sparsity(scores, threshold)


def test_plots_write_their_files(tmp_path):
    m = np.random.default_rng(2).random((8, 8))
    statistic.plot_heatmap(m, str(tmp_path / "h.png"), title="h")
    statistic.plot_histogram(m, str(tmp_path / "g.png"), bins=10, log=True)
    assert os.path.getsize(tmp_path / "h.png") > 0 and os.path.getsize(tmp_path / "g.png") > 0


@pytest.mark.parametrize("h,w,c,seed", [(32, 48, 3, 0), (17, 9, 1, 5), (8, 8, 4, 2)])
def test_make_random_image_matches_jax(h, w, c, seed):
    a = image_utils.make_random_image(h, w, c, seed)
    b = jimage.make_random_image(h, w, c, seed)
    assert a.size == b.size == (w, h) and a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
