"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Sources live in packnet_sfm_tpu_torch/csrc and build at first use
(see build.py)."""
