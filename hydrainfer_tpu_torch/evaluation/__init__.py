"""Evaluation scripts of the port (twins of the JAX package's `evaluation/`
scripts that import it). Quality: perplexity, the quantization-quality
table, the correctness dumps and the model-size table. Speed, driving the
engine: interference (encode / prefill / decode head-of-line blocking),
ab_bench (interleaved A/B of engine variants), spec_bench (speculation on
against off) and method_sweep (the disaggregation layouts as node
processes). Each runs on the card unless given `--device cpu`, and imports
nothing of JAX."""
