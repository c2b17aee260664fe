"""vitsom-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``vitsom_tpu``: same module tree,
same yaml configs, same public layouts (NHWC images, [B, N, H, hd] attention
tensors, [B, N*D] SOM latents). It imports torch, numpy and yaml, never JAX
or the JAX package. Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU; each TPU kernel of the ported paths is a
hand-written CUDA kernel under ``ops/csrc``, built by nvcc at first use.
"""
