"""spacedrive_tpu_torch: the PyTorch/CUDA port of spacedrive_tpu.

Module layout mirrors the JAX package (ops/, parallel/, files/,
location/indexer/, object/media/thumbnail/, models/). It imports torch,
numpy and PIL, never jax and nothing of spacedrive_tpu. Entry points run
on "cuda" unless the caller passes device="cpu"; importing builds no
kernel and needs no CUDA.
"""
