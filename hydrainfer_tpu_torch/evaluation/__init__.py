"""Quality scripts of the port (port of the JAX package's `evaluation/`
scripts that import it): perplexity, the quantization-quality table, the
correctness dumps and the model-size table. Each runs on the card unless
given `--device cpu`, and imports nothing of JAX."""
