"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12         # fp32 on the CUDA cores, outside the tensor cores
HBM_BYTES = 3.35e12        # device memory bandwidth, bytes a second
CARD = "NVIDIA H100 80GB HBM3"
