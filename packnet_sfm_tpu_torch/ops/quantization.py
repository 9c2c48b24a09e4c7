"""
INT8 quantization (the JAX package's ops/quantization.py): the uint8
fake-quantizer of the heads' sigmoids, the per-output-channel int8
fake-quantizer of the depth net's conv kernels, both with straight-through
gradients for quantization-aware training, and the depth error each head
design takes from 8-bit outputs.

- single-head linear:   depth = 1 / (min_inv + range * Q(sig))
- single-head log:      depth = 1 / exp(lerp(log min_inv, log max_inv, Q(sig)))
- dual-head:            depth = Q(int_sig) * max_depth + Q(frac_sig)

`quantize_depth_net_params` returns {parameter name: quantized tensor} for
the model's depth-net conv kernels; a step runs the model over them with
torch.func.functional_call (parallel/train_step.py), so the module and its
state-dict names stay as they are and the optimizer updates the latent
float weights.

The values are those of the JAX package's steps bit for bit. Those run the
quantizers under jit, where XLA turns a division by a constant into a
product with the constant's float32 reciprocal: x / 255 is x * (1/255),
and the weight scale amax / 127 is amax * (1/127). So do these. (JAX's
quantizers called outside jit divide, one ulp away on some values.)
"""

import torch

from packnet_sfm_tpu_torch.ops.depth import (
    dual_head_to_depth, sigmoid_to_depth_linear, sigmoid_to_depth_log)
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_kernel_axis)


def fake_quant_u8(x):
    """Uniform 8-bit fake quantization of a [0, 1] tensor (round to
    nearest, ties to even)."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) * (1.0 / 255.0)


def _ste(x, q):
    """Straight-through estimator: forward q, backward identity to x."""
    return x + (q - x).detach()


def ste_quant_u8(x):
    """fake_quant_u8 with a straight-through gradient (QAT on outputs)."""
    return _ste(x, fake_quant_u8(x))


def fake_quant_weight_per_channel(w, bits=8, axis=-1):
    """Symmetric per-output-channel weight fake quantization with a
    straight-through gradient: output channel `axis` (the last for the
    flax HWIO layout, 0 for an OIHW nn.Conv2d weight) gets its own scale
    max|w| / (2^(bits-1) - 1); a zero channel quantizes to zero (the scale
    is floored at 1e-12)."""
    qmax = float(2 ** (bits - 1) - 1)
    axis = axis % w.ndim
    amax = w.abs().amax(dim=tuple(d for d in range(w.ndim) if d != axis),
                        keepdim=True)
    scale = amax.clamp(min=1e-12) * (1.0 / qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax) * scale
    return _ste(w, q)


def depth_net_kernels(model):
    """{name: output-channel axis} of the parameters the JAX package
    quantizes: every leaf named `kernel` with ndim >= 2 under `depth_net`,
    through the port's flax layout map (utils/flax_weights.py). Biases, BN
    and MaskedBatchNorm, the fusion gates and the pose net stay float."""
    out = {}
    for name, p in model.named_parameters():
        if name.split('.')[0] != 'depth_net' or p.ndim < 2:
            continue
        axis = flax_kernel_axis(model, name)
        if axis is not None:
            out[name] = axis
    return out


def quantize_depth_net_params(model, bits=8, kernels=None):
    """{name: fake-quantized tensor (straight-through: gradients reach the
    parameter)} for `model`'s depth-net conv kernels (`depth_net_kernels`,
    or `kernels` as it returns). A model without a depth net gives {}."""
    params = dict(model.named_parameters())
    kernels = depth_net_kernels(model) if kernels is None else kernels
    return {name: fake_quant_weight_per_channel(params[name], bits, axis)
            for name, axis in kernels.items()}


def quantized_depth_single(sig, min_depth, max_depth, use_log_space=False):
    q = fake_quant_u8(sig)
    if use_log_space:
        return sigmoid_to_depth_log(q, min_depth, max_depth)
    return sigmoid_to_depth_linear(q, min_depth, max_depth)


def quantized_depth_dual(integer_sig, fractional_sig, max_depth):
    return dual_head_to_depth(fake_quant_u8(integer_sig),
                              fake_quant_u8(fractional_sig), max_depth)


def quantization_error_report(min_depth=0.5, max_depth=15.0, n=4096):
    """The worst and mean absolute depth error, in mm, that 8-bit outputs
    give each head design over `n` depths spanning [min_depth, max_depth]
    (the reference's +-28.4 mm single against +-1.96 mm dual analysis)."""
    depths = torch.linspace(min_depth, max_depth, n)
    min_inv, max_inv = 1.0 / max_depth, 1.0 / min_depth
    sig_lin = (1.0 / depths - min_inv) / (max_inv - min_inv)
    dec_lin = quantized_depth_single(sig_lin, min_depth, max_depth, False)

    log_min = torch.log(torch.tensor(min_inv))
    log_max = torch.log(torch.tensor(max_inv))
    sig_log = (torch.log(1.0 / depths) - log_min) / (log_max - log_min)
    dec_log = quantized_depth_single(sig_log, min_depth, max_depth, True)

    int_sig = torch.floor(depths) / max_depth
    frac_sig = depths - torch.floor(depths)
    dec_dual = quantized_depth_dual(int_sig, frac_sig, max_depth)

    def stats(dec):
        err = (dec - depths).abs()
        return {'max_mm': float(err.max() * 1000),
                'mean_mm': float(err.mean() * 1000)}

    return {'single_linear': stats(dec_lin), 'single_log': stats(dec_log),
            'dual_head': stats(dec_dual)}
