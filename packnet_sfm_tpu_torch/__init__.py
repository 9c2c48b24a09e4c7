"""
PyTorch/CUDA port of packnet_sfm_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports none of
it. Public functions keep the JAX package's NHWC layout and HWIO masked-conv
kernels; modules may run NCHW inside. Entry points default to the card and
raise when CUDA is absent unless the caller passes device='cpu'.
"""

from packnet_sfm_tpu_torch.device import resolve_device  # noqa: F401
