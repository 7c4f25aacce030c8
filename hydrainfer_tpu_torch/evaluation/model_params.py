"""Model size and decode roofline table (port of evaluation/model_params.py).

For an HF checkpoint (--path) or a built-in random-weight architecture
(--arch, from shapes alone: the tree is built on the "meta" device), it
gives the vision and language parameter counts, the language model's weight
bytes at bf16 / int8 / int4, the KV-cache bytes a token (an MLA model's
single-plane latent cache once a token, where the JAX script counts two
planes), and the decode
roofline at a few batch sizes: batch over the time to read the weights once
at the H100 SXM's 3.35 TB/s (the card's rate, where the JAX script divides
by a TPU v5e's). The card's name and power limit are printed beside it
(nvidia-smi), or that there is none.

Usage:
  python -m hydrainfer_tpu_torch.evaluation.model_params --arch qwen2-vl-2b-lm
  python -m hydrainfer_tpu_torch.evaluation.model_params --path CKPT [--device cpu]
"""
import argparse
import json
import subprocess

H100_HBM_BW = 3.35e12      # bytes/s, H100 SXM HBM3


def table_for(factory, hbm_bytes_per_s: float = H100_HBM_BW) -> dict:
    cnt = factory.getModelParamsCount()
    lc = factory.getLanguageModelConfig()
    lm_params = cnt.language_model_params
    planes = 1 if lc.kv_single_plane else 2 * lc.n_kv_heads
    kv_per_token = lc.n_layers * planes * lc.head_dim          # elements
    rows = {}
    for name, bytes_per in (("bf16", 2), ("int8", 1), ("int4", 0.5)):
        wbytes = lm_params * bytes_per
        rows[name] = {
            "weight_gb": round(wbytes / 1e9, 2),
            "decode_roofline_tok_s": {
                b: int(b / (wbytes / hbm_bytes_per_s)) for b in (8, 32, 128)},
        }
    return {
        "vision_params_m": round(cnt.vision_model_params / 1e6, 1),
        "lm_params_m": round(lm_params / 1e6, 1),
        "kv_bytes_per_token_bf16": kv_per_token * 2,
        "roofline_hbm_bytes_per_s": hbm_bytes_per_s,
        "by_weight_dtype": rows,
    }


def card_name_and_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or why none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:          # no card or no nvidia-smi: say so
        return f"nvidia-smi unavailable ({e})"


def device_label(device: str) -> str:
    """"cpu", or the card's name and power limit."""
    return "cpu" if device == "cpu" else card_name_and_limit()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="random-weight arch preset")
    ap.add_argument("--path", default=None, help="HF checkpoint dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where a checkpoint's weights load: cuda (default) or cpu")
    args = ap.parse_args()
    if args.path:
        from ..models.factory import ModelFactoryConfig, getModelFactory
        factory = getModelFactory(ModelFactoryConfig(path=args.path, dtype="bf16"),
                                  device=args.device)
        name = args.path
    else:
        from ..models.random_init import RandomWeightFactory
        name = args.arch or "qwen2-vl-2b-lm"
        factory = RandomWeightFactory(name, device="meta")
    summary = {"model": name, **table_for(factory),
               "roofline_rate": "H100 SXM HBM3, 3.35 TB/s",
               "card": card_name_and_limit()}
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
