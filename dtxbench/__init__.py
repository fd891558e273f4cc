"""dtxbench: the benchmark of the PyTorch/CUDA port, detex_tpu_torch (see
run.py).  It imports neither jax nor the JAX package, detex_tpu."""
