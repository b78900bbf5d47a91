"""The LLM backbone of the port (zamba2's mamba2 + shared attention, dense
GQA attention with qk-norm), plain functions over nested dicts of tensors
with the JAX package's parameter layout."""
