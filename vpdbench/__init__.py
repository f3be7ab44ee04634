"""The benchmark of the PyTorch and CUDA port (`vpd_tpu_torch`): see
README.md. Nothing here imports JAX or the JAX package `vpd_tpu`."""
