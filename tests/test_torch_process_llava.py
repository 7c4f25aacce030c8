"""The process deployment on LLaVA-1.5 against the JAX package, on the CPU.

The tiny LLaVA-1.5 checkpoint of tests/test_torch_llava.py (CLIP 3 layers x
32 wide over 28-pixel images, a 2-layer Llama 48 wide, image token 60) is
built in process with transformers, with its CLIP image processor and a
character-level tokenizer ("<image>" at id 60) saved beside it. The port's
ProcessCluster serves E + P + D as three spawned children: an image request
and a text request enter the E node, the image's features migrate E -> P
and both requests' KV P -> D across the process boundaries (shared memory:
the caches live on the CPU). In f32 and with int8 weights and an int8 KV
cache, the greedy tokens equal the JAX E + P + D nodes' (in process, as
tests/test_torch_disagg.py wires them) on the same checkpoint.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
Image = pytest.importorskip("PIL.Image")

from hydrainfer_tpu.request import Request as JaxRequest  # noqa: E402
from hydrainfer_tpu.request import SamplingParameters as JaxSP  # noqa: E402
from hydrainfer_tpu_torch.request import Request, SamplingParameters  # noqa: E402
from test_torch_process_parity import (QUANT, QUANT_IDS, jax_in_process,  # noqa: E402
                                       jax_node_config, port_cluster, port_node_config,
                                       save_char_tokenizer, serve_port)

IMAGE_ID = 60


@pytest.fixture(scope="module")
def llava_ckpt(tmp_path_factory):
    """tests/test_torch_llava.py's tiny LLaVA-1.5, with a tokenizer."""
    path = tmp_path_factory.mktemp("process_llava")
    cfg = transformers.LlavaConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                           num_attention_heads=2, image_size=28, patch_size=14,
                           num_channels=3, hidden_act="quick_gelu"),
        text_config=dict(model_type="llama", vocab_size=64, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=128),
        image_token_index=IMAGE_ID, vision_feature_layer=-2,
        vision_feature_select_strategy="default")
    torch.manual_seed(0)
    transformers.LlavaForConditionalGeneration(cfg).eval().to(torch.float32).save_pretrained(
        path, safe_serialization=True)
    transformers.CLIPImageProcessor(size={"shortest_edge": 28},
                                    crop_size={"height": 28, "width": 28}).save_pretrained(path)
    save_char_tokenizer(path, 64, image_id=IMAGE_ID)
    return str(path)


def image(h, w, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def mm_requests(req_cls, sp_cls):
    sp = lambda n: sp_cls(max_tokens=n, ignore_eos=True)
    return [req_cls(request_id="m0", prompt="<image> !%&!", image=image(40, 50, 1),
                    sampling_params=sp(8)),
            req_cls(request_id="t0", prompt="!! % &&", sampling_params=sp(8))]


@pytest.mark.parametrize("quant,kv_int8", QUANT, ids=QUANT_IDS)
def test_epd_processes_match_jax_nodes(llava_ckpt, quant, kv_int8):
    # the children boot while the JAX nodes serve the reference
    cluster = port_cluster(["E", "P", "D"], port_node_config(llava_ckpt, quant, kv_int8))
    ref = jax_in_process(["E", "P", "D"], jax_node_config(llava_ckpt, quant, kv_int8),
                         mm_requests(JaxRequest, JaxSP))
    got, metrics = serve_port(cluster, mm_requests(Request, SamplingParameters))
    assert [len(t) for t in got] == [8, 8]
    assert got == ref
    assert metrics["PNode:p0"]["migration_pulls"] == 1      # the image's features
    assert metrics["DNode:d0"]["migration_pulls"] == 2
    assert metrics["DNode:d0"]["migration_shm_pulls"] == 2
