"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit)."""

INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# a dtype as the configuration names its compute -> its peak
PEAK = {"int8": INT8_OPS_PER_S, "bf16": BF16_FLOPS_PER_S, "tf32": TF32_FLOPS_PER_S,
        "f32": F32_FLOPS_PER_S}
