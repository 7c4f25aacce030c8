"""Import hygiene and device defaults of the port.

In a fresh interpreter, importing every module of hydrainfer_tpu_torch (its
quality scripts under hydrainfer_tpu_torch/evaluation included) and
everything chip_smoke.py and k4_plan_sweep.py import must load no `jax*` module, nothing of the
JAX package and nothing of the JAX package's `evaluation` scripts. The entry points default to the card: without one they
raise, unless the caller passes device="cpu".
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import json
import os
import subprocess
import sys

import pytest
import torch

from hydrainfer_tpu_torch.cluster.node import NodeConfig
from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
from hydrainfer_tpu_torch.memory import (TokenCacheBlockManager,
                                         TokenCacheBlockManagerConfig)
from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig
from hydrainfer_tpu_torch.models.llava import LlavaModelFactory
from hydrainfer_tpu_torch.models.qwen2_vl import Qwen2VLModelFactory
from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
from hydrainfer_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import hydrainfer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hydrainfer_tpu_torch.__path__,
                                               "hydrainfer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke   # its phases import only modules of the walk above
import k4_plan_sweep
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "hydrainfer_tpu" or m.startswith("hydrainfer_tpu.")
             or m == "evaluation" or m.startswith("evaluation."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "hydrainfer_tpu_torch.entrypoint.offline" in res["imported"]
    for name in ("ops.cuda.build", "ops.cuda.mha_varlen", "models.qwen2_vl",
                 "models.weight_loader", "ops.cuda.paged_attention_latent",
                 "models.clip", "models.llava", "ops.token_pruning",
                 "cluster.rpc", "cluster.process_node", "utils.socket_utils",
                 "utils.zmq_utils", "ops.moe", "models.deepseek_v3",
                 "models.deepseek_vl2", "models.mixtral", "models.gpt2", "utils.debug",
                 "utils.profiler", "utils.statistic", "utils.image_utils",
                 "evaluation", "evaluation.perplexity", "evaluation.quant_quality",
                 "evaluation.test_correctness", "evaluation.model_params"):
        assert "hydrainfer_tpu_torch." + name in res["imported"]
    assert res["bad"] == []


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert RandomWeightFactory("tiny-lm").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        RandomWeightFactory("tiny-lm")
    with pytest.raises(RuntimeError, match="CUDA"):
        Qwen2VLModelFactory(ModelFactoryConfig(path="no-checkpoint-needed"))
    with pytest.raises(RuntimeError, match="CUDA"):
        LlavaModelFactory(ModelFactoryConfig(path="no-checkpoint-needed"))
    with pytest.raises(RuntimeError, match="CUDA"):
        RandomWeightFactory("tiny-lm", multimodal=True)
    cfg = TokenCacheBlockManagerConfig(n_layers=1, n_blocks=4, block_size=4,
                                       n_heads=2, head_dim=8, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenCacheBlockManager(cfg)
    cpu_factory = RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        OfflineEngine(NodeConfig(n_kv_blocks=8), model_factory=cpu_factory)


def test_entry_points_run_on_the_cpu_when_asked():
    factory = RandomWeightFactory("tiny-lm", dtype=torch.float32, device="cpu")
    engine = OfflineEngine(NodeConfig(n_kv_blocks=16), model_factory=factory,
                           device="cpu")
    assert engine.node.kv_cache_manager.cache_array.device.type == "cpu"
    assert factory.getLanguageModel().weights["embed"].device.type == "cpu"
