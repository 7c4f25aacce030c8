"""Correctness dumps: deterministic generation through the serving stack,
dumped for comparison across devices, dtypes and quantizations (port of
evaluation/test_correctness.py).

Usage:
  python -m hydrainfer_tpu_torch.evaluation.test_correctness --model-path CKPT \
      --num-prompts 16 --max-tokens 32 --output correctness.json [--device cpu]
  # then compare two dumps:
  python -m hydrainfer_tpu_torch.evaluation.test_correctness --compare a.json b.json
"""
import argparse
import json

import numpy as np

# the prompts' words: a word-level tokenizer over them (save_word_tokenizer)
# gives each word one id
WORDS = ["the", "a", "of", "to", "and", "in", "is", "it", "you", "that"]


def prompts(n_prompts: int) -> list:
    """The script's seeded prompts: 8 to 31 of WORDS, space-separated."""
    rng = np.random.default_rng(0)
    return [" ".join(rng.choice(WORDS, size=rng.integers(8, 32))) for _ in range(n_prompts)]


def run_generate(model_path: str, n_prompts: int, max_tokens: int, dtype: str = "bf16",
                 quantization: str = "none", device=None) -> list:
    """Greedy generation (ignore_eos) of the script's prompts through the
    port's OfflineEngine on `device` (the card by default): [{"prompt",
    "output_token_ids", "text"}]."""
    from ..cluster.node import NodeConfig
    from ..engine.request_processor import RequestProcessorConfig
    from ..entrypoint.offline import OfflineEngine
    from ..models.factory import ModelFactoryConfig, getModelFactory
    from ..request import Request, SamplingParameters

    cfg = NodeConfig(request_processor=RequestProcessorConfig(
        num_request_process_workers=1))
    cfg.model = ModelFactoryConfig(path=model_path, dtype=dtype, quantization=quantization)
    engine = OfflineEngine(cfg, getModelFactory(cfg.model, device=device), device=device)
    texts = prompts(n_prompts)
    outs = engine.generate([
        Request(request_id=i, prompt=p,
                sampling_params=SamplingParameters(max_tokens=max_tokens, ignore_eos=True))
        for i, p in enumerate(texts)], timeout_s=1200)
    return [{"prompt": p, "output_token_ids": o.output_token_ids, "text": o.text}
            for p, o in zip(texts, outs)]


def compare_dumps(a: list, b: list) -> dict:
    """Exact matches and each pair's first diverging position (None: equal
    as far as the shorter goes)."""
    n_match = sum(1 for x, y in zip(a, b) if x["output_token_ids"] == y["output_token_ids"])
    first_div = []
    for x, y in zip(a, b):
        ids_a, ids_b = x["output_token_ids"], y["output_token_ids"]
        first_div.append(next((i for i, (p, q) in enumerate(zip(ids_a, ids_b)) if p != q),
                              None))
    return {"n": len(a), "n_exact_match": n_match, "match_rate": n_match / max(len(a), 1),
            "first_divergence": first_div}


def compare(path_a: str, path_b: str) -> dict:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    return compare_dumps(a, b)


def save_word_tokenizer(path: str, vocab_size: int) -> None:
    """A word-level HF tokenizer into `path`: <unk> <s> </s>, then WORDS
    (ids 3-12), then filler tokens up to vocab_size; split on whitespace,
    decoded with a space between words."""
    import tokenizers
    from transformers import PreTrainedTokenizerFast
    vocab = ["<unk>", "<s>", "</s>"] + WORDS
    vocab += [f"<x{i}>" for i in range(vocab_size - len(vocab))]
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {t: i for i, t in enumerate(vocab)}, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path")
    ap.add_argument("--num-prompts", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--output", default="correctness.json")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare), indent=2))
        return
    results = run_generate(args.model_path, args.num_prompts, args.max_tokens, args.dtype,
                           args.quant, device=args.device)
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.output} ({len(results)} prompts)")


if __name__ == "__main__":
    main()
