"""UniMM-UL on PyTorch and CUDA (NVIDIA Hopper): a port of the JAX
package ``unimm_tpu``, which stays the reference."""
