"""filodb_tpu_torch: the PyTorch/CUDA port of filodb_tpu (see README,
"PyTorch/CUDA port"). Imports neither JAX nor any ``filodb_tpu`` module."""
