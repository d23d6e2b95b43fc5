"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``), each
beside the plain PyTorch version the CPU path runs."""
from __future__ import annotations


def launch_counters() -> dict:
    """Every kernel's launch counter by name: an object whose int
    ``launches`` its wrapper raises by one where it launches the kernel
    (``rms_norm``, ``layer_norm``, ``softmax_xent_fwd``/``_bwd``, and for
    each flash pass ``flash_{fwd,dq,dkv}`` (the FMA route's fp32 kernels)
    with ``_wgmma``, ``_bias``, ``_wgmma_bias``, ``_wgmma_keybias``,
    ``_mma`` and ``_mma_bias``)."""
    from . import cross_entropy, flash_attention, norms
    out = {"rms_norm": norms.rms_norm, "layer_norm": norms.layer_norm,
           "softmax_xent_fwd": cross_entropy.softmax_xent_fwd,
           "softmax_xent_bwd": cross_entropy.softmax_xent_bwd}
    for kind in ("fwd", "dq", "dkv"):
        w = getattr(flash_attention, "flash_" + kind)
        out.update({f"flash_{kind}": w, f"flash_{kind}_wgmma": w.wgmma,
                    f"flash_{kind}_bias": w.bias,
                    f"flash_{kind}_wgmma_bias": w.wgmma_bias,
                    f"flash_{kind}_wgmma_keybias": w.wgmma_keybias,
                    f"flash_{kind}_mma": w.mma,
                    f"flash_{kind}_mma_bias": w.mma_bias})
    return out
