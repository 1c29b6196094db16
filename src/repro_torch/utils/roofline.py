"""Roofline terms of a counted call on one NVIDIA H100 SXM: the port of
:mod:`repro.utils.roofline`, whose constants are a TPU v5e's.

    compute term    = FLOPs_per_device / peak FLOP/s (``peak_flops``)
    memory term     = bytes_per_device / HBM rate
    collective term = collective_wire_bytes_per_device / link rate

The FLOPs and bytes come from :func:`repro_torch.utils.cost.analyze`, per
device; the collective bytes from the ring model of
:mod:`repro_torch.utils.collectives`. ``model_flops`` keeps the 6·N·D
(train) / 2·N·D (inference) convention, with N_active for MoE.

The constants are the H100 SXM5's dense figures from NVIDIA's H100 Tensor
Core GPU data sheet (the "H100 SXM" column).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989.4e12      # bf16 tensor core, dense (data sheet: 1,979 TFLOPS with sparsity)
PEAK_FLOPS_FP32 = 66.9e12  # float32, non-tensor (data sheet: 67 TFLOPS)
HBM_BW = 3.35e12           # bytes/s, HBM3 (data sheet: 3.35 TB/s)
LINK_BW = 450e9            # bytes/s one direction: NVLink's 900 GB/s counts both, the ring
                           # model counts the bytes one device sends


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_per_device: float
    peak_flops: float = PEAK_FLOPS     # PEAK_FLOPS_FP32 for a float32 model

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        if self.flops_per_device == 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization the roofline permits (useful work over
        peak at the bottleneck-dictated step time)."""
        if self.step_s == 0:
            return 0.0
        return self.model_flops_per_device / (self.step_s * self.peak_flops)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops(num_params: int, tokens: int, kind: str) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * num_params * tokens
