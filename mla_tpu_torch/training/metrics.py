"""Training throughput accounting.

Counterpart of the MFU accounting of mla_tpu/training/metrics.py
(`decoder_flops_per_token`) plus the card's peak rate.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from mla_tpu_torch.params import tree_leaves

# dense bf16 tensor-core peaks (NVIDIA data sheets), by device-name fragment
BF16_PEAK_FLOPS = {"H100 PCIe": 756e12, "H100": 989e12, "H200": 989e12}


def decoder_flops_per_token(llm_params: Dict[str, Any], use_diff: bool) -> float:
    """Model FLOPs per decoder token, 6N (remat recompute not counted). N
    counts what runs per token: the decoder without the embedding table (a
    lookup) and, in diffusion mode, without the LM head (never projected).
    The front-ends run once per frame and are left out, so MFU is a slight
    undercount."""
    skip = {"embed"} | ({"lm_head"} if use_diff else set())
    return 6.0 * sum(l.numel() for k, sub in llm_params.items() if k not in skip for l in tree_leaves(sub))


def bf16_peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak from its name, or None if unknown."""
    for frag, peak in BF16_PEAK_FLOPS.items():
        if frag in device_name:
            return peak
    return None
